#!/usr/bin/env python3
"""On-card smoke run of graphite_tpu_torch (the PyTorch/CUDA port).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and the CUDA
toolkit; builds the kernels from `graphite_tpu_torch/csrc/` at first use.
Phases, one JSON line each:

 1. device: the card, its power limit, torch/CUDA versions;
 2. build: the fourteen kernel libraries (sixteen kernels:
    lane_fetch_cost has a lax_p2p entry point, mem_home_start one for
    MOSI and the limited schemes), one `nvcc` each, in parallel, and
    what `-Xptxas -v` says of each (registers, spills);
 3. kernels: each kernel against its plain PyTorch version on the card,
    `torch.equal` on every output and every state tensor it updates —
    on every iteration of the first part of the full-width (1024-tile)
    FFT run, and on hand-made edge cases (ANY_SENDER ties, a full ring,
    every lane an ANY_SENDER receiver, all-to-one sends with a named or
    ANY_SENDER receive of a same-iteration send, self-sends, overflow and
    pop in one iteration; barrier-init races with negative counts, 1024
    lanes arriving at one barrier, several releases in one iteration, a
    split barrier across the generation ring's wrap, 1 and 1024
    barriers, lane counts that are not a multiple of the block, idle
    tables and a barrier already due; fetches at both ends of the row
    with predictors of 1024 and 1000 entries; follow-on windows cut by
    the row's end and by qend under per-lane frequencies); then, at the
    main path's shapes and at three states of the FFT (the send phase,
    iteration 200; the receive phase, iteration 1060; the barrier phase,
    the first iteration at which at least half the lanes are active at
    BARRIER_WAIT, found while checking), each kernel's device time per
    call (a CUDA graph of 100 calls, host overhead excluded), its time
    per eager call (host included; also with the binding dropped before
    every call, i.e. validating every argument each call) and its plain
    version's time; and `lane_commit` alone at a follow-on state (every
    lane at a PLAIN record with a window of PLAIN records behind it, one
    frequency), which the FFT never reaches;
 4. end to end: the FFT at 64 and 256 tiles and the message ring at 64
    tiles on the card and on the CPU (plain path): every SimResults
    field, n_quanta and last_n_iterations equal;
 5. full width: the headline config (1024 tiles, SPLASH-2 FFT with 2048
    points a tile, emesh_hop_counter, lax) through Simulator.warmup() and
    RUNS timed .run()s from the same initial state; every tile done, the
    instruction total checked against the trace, and on each run every
    kernel launched exactly once per iteration and packed (validated
    its arguments) at most once; then torch.profiler windows over one
    `inner_block` of the same run at each of the three timing states:
    kernel device time and launches by name (one device launch a call
    for every kernel), and the device's busy share.

The memory slice (the private-L1/L2 MSI engine and the iocoom core):
 6. memory kernels: every kernel of the 64-tile iocoom + MSI FFT
    companion (bench.py's coherence companion) and of a 64-tile
    coherence stress run against its plain version, iteration by
    iteration, and six edge families (a dirty L2 victim, NULLIFY of a
    directory victim with sharers, line -1 victims under round-robin
    replacement, requester_unroll = 4, two lanes storing one functional
    word, 1024 tiles with 32 sharer words); then the four memory
    kernels and the extended `lane_commit` timed at the companion's
    first miss-heavy state, from that very state each call;
 7. card against CPU: the companion and a 16-tile stress run, every
    SimResults field and the line census equal;
 8. the companion at full width: warmup and MEM_RUNS timed runs (all
    eight kernels launched), a torch.profiler window;

The contention NoCs of the USER net (emesh_hop_by_hop and ATAC):
 9. NoC kernels: bench.py's 256-tile hop-by-hop RADIX and the same RADIX
    under ATAC, each kernel against its plain version on their first
    RADIX_CHECKED iterations; `noc_route` / `atac_route` and the routed
    `user_mailbox` timed at the first all-to-all state; the edge states
    (all lanes to one tile, one row crossed, self-sends, M/G/1-fallback
    cells, no sender, contention off, 1024 tiles, distance_based ATAC),
    each with the counts that show its branch;
10. card against CPU: both RADIX paths at 64 tiles, every SimResults
    field and the final NoC queues equal;
11. both 256-tile RADIX paths timed: warmup and RADIX_RUNS runs (the
    route kernel and the step's four launched once an iteration), a
    torch.profiler window;

The contention NoCs as the MEMORY net (emesh_hop_by_hop and ATAC):
12. the companion under each net, its first NET_CHECKED iterations
    checked phase by phase (the three memory kernels route inside;
    phases 4-5 as the replay of their CUDA graph, which launches
    `mem_net_route` twice, against the same phases routed by its plain
    version), then the four kernels timed at its first miss-heavy
    state; edge states of the routes and fan-outs, each with the counts
    that show its branch;
13. card against CPU: the 16-tile mutex-serialized and line-disjoint
    traces and the companion under each net, every SimResults field,
    the line census and `MemState.noc` equal;
14. the companion under each net timed (MEM_RUNS runs, exact launch
    counts an iteration) and a torch.profiler window (`mem_net_route`
    two device launches a call);
15. the north star: the 1024-tile FFT with its loads on MSI full_map
    (auto directory, emesh_hop_counter, lax_barrier) once to completion;
    then its hop-by-hop rung (emesh_hop_by_hop as the USER and the
    MEMORY net) once to completion.

The outputs slice (lax_p2p, barrier_host, the generators, the outputs):
16. p2p kernel: the 1024-tile FFT under lax_p2p at a 10 ns slack, its
    kernels (the lax_p2p instantiation of `lane_fetch_cost`, counted as
    `lane_fetch_cost[p2p]`) against their plain versions on P2P_CHECKED
    iterations from the first receive (the sends before it hold no
    lane), the held lanes counted; the four kernels timed at a send
    state and at a receive state with held lanes;
17. p2p edge states, each with the count that shows its branch: a
    partner fetching THREAD_EXIT on this very iteration, 1, 2, 37 and
    1,000 tiles, the round counter at 2**31 - 1 and its wrap, every lane
    but one laggard ahead, models disabled;
18. card against CPU: the 64-tile FFT and the two-tile skew trace under
    lax_p2p, a 16-tile MSI stress run under lax_p2p, and a 64-tile
    lax_barrier FFT with barrier_host=True, barrier_batch=3;
19. the headline under lax_p2p (default slack) timed: P2P_RUNS runs in
    turns with as many lax runs, the p2p kernel and the other three once
    an iteration, results equal to the lax headline's; then one timed
    run to completion at a 10 ns slack, where lanes are held;
20. workloads: blackscholes (1,024 tiles, the headline config) and
    canneal (1,024 tiles, MSI full_map, lax_barrier) once each; ping-pong
    (`config_text(16)`) and every other BENCHMARKS entry at 64 tiles,
    card against CPU;
21. outputs: sim.out and carbon_sim.cfg of a 64-tile MSI run, card
    against CPU byte for byte; a checkpoint saved mid-run on the card
    and resumed on the card, equal to the uninterrupted run; the chunked
    StatisticsManager's files, card against CPU byte for byte.

MOSI and the four limited directory schemes on the private-L2 engine:
22. edge states, each kernel against its plain version, each showing its
    branch by the leaves that differ from the MSI full_map result of the
    same state (`mem_home_start`: the cache-to-cache SH fetch from an
    OWNED entry's owner and from the lowest sharer, the
    INV_FLUSH_COMBINED supplier of an EX on SHARED and on OWNED, the
    limited_no_broadcast displacement under MSI and MOSI, the owner as
    the only victim, the MODIFIED entry at capacity, the ackwise and
    limited_broadcast sweep to every tile — also under each contention
    net, one sweep a home —, the limitless trap at a 700 MHz directory;
    `mem_requester`: the upgrade of an OWNED line, a FLUSH;
    `mem_requester_fill`: an OWNED victim, a FLUSH); under MOSI or a
    limited scheme phase 3 launches `mem_home_start[ext]`, counted
    apart;
23. card against CPU: the 64-tile canneal (256-line footprint) under MOSI
    with each limited scheme at k = 4, its first MOSI_CHECKED iterations
    checked kernel by kernel, and the 16-tile stress trace under MOSI +
    ackwise (k = 2) over each contention MEMORY net; every SimResults
    field, the line census and `MemState.noc` equal (the CPU sides run
    in the worker process, queued behind the MEMORY-net slice's);
24. the three memory kernels timed at the companion's miss-heavy state
    under MOSI + ackwise (k = 4), beside the same call's MSI times;
25. the slice's main path checked at its own shapes: canneal at 1,024
    tiles (4,096-line footprint) on MOSI + ackwise (k = 4) run to its
    first quantum of MOSI_BURST broadcasts or more, then the MOSI_WINDOW
    iterations of that quantum that hold the most broadcasts checked
    kernel by kernel, and `mem_home_start[ext]` timed at its iteration
    with the most broadcast rows and at one with none;
26. the slice's main path: the same canneal once to completion from
    launch counts at 0 (func_errors 0, dir_broadcasts > 0, phase 3
    only through `mem_home_start[ext]`); then under
    limited_no_broadcast and limitless, their invalidations and the
    entries left over k.

The shared-L2 engine (pr_l1_sh_l2_msi / _mesi):
27. edge states, each shl2 kernel against its plain version, each with
    the count that shows its branch (a NULLIFY of a slice victim with
    sharers and the saved request after it, a request to a line still
    DATA_INVALID, MESI's EXCLUSIVE fill, silent promote and WB
    downgrade, an ackwise broadcast row at 1,024 tiles (timed, beside
    the same sweep without a row) and an upgrade's at 40, the
    limited_no_broadcast displacement, the limitless trap, a fill
    waiting on a busy eviction cell; 40 tiles: a padded sharer word);
28. card against CPU: the 64-tile canneal under shared-L2 MSI and MESI
    with full_map, ackwise, limited_no_broadcast and limitless (k = 4)
    and the 16-tile stress under shared-L2 MSI + ackwise (k = 2) over
    each contention MEMORY net, each's first SHL2_CHECKED iterations
    checked kernel by kernel;
29. the slice's main path checked at its own shapes: canneal at 1,024
    tiles on shared-L2 MESI, the first quantum with the most fills among
    its first SHL2_SCAN, the SHL2_WINDOW iterations of it that hold the
    most L1 misses checked kernel by kernel, each of the three kernels
    timed at the iteration where its own work peaks;
30. that canneal once to completion from launch counts at 0 (func_errors
    0, each shl2 kernel once an iteration, no private-L2 memory
    kernel), then under shared-L2 MSI.

Then the kernels line (the eleven, `lane_fetch_cost[p2p]`,
`mem_home_start[ext]` and the three shared-L2 kernels), the
card's name and power limit, and last `{"ok": true, "device": {...}}`.
Any failure exits non-zero before the last line.  Each phase's line
carries `t_s`, the script's seconds so far, and `phase_s`, the seconds
since the line before it.  Imports nothing of JAX or of the JAX package.
To compare two trees on one card, run each tree's own copy of this script
in one call (parent, change, change, parent); `python3 chip_smoke.py
--ab headline|companion|north_star|mem_kernels TREE [TREE ...]` times the
headline, the companion, the north star or the three memory kernels at
the companion's miss-heavy state alone with the package of each tree,
in turns (A B B A).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 bandwidth
INT_OPS_PER_S = 67e12          # H100 SXM non-tensor-core fp32 peak rate,
#                                used for the integer lane arithmetic
REPLACES = {
    "lane_fetch_cost": "graphite_tpu/engine/step.py:193",
    "user_mailbox": "graphite_tpu/engine/step.py:413",
    "barrier_sync": "graphite_tpu/engine/step.py:505",
    "lane_commit": "graphite_tpu/engine/step.py:842",
    "mem_requester": "graphite_tpu/memory/engine.py:1378",
    "mem_home_start": "graphite_tpu/memory/engine.py:2219",
    "mem_requester_fill": "graphite_tpu/memory/engine.py:2547",
    "iocoom_commit": "graphite_tpu/models/iocoom.py:129",
    "noc_route": "graphite_tpu/models/network_hop_by_hop.py:123",
    "atac_route": "graphite_tpu/models/network_atac.py:176",
    "mem_net_route": "graphite_tpu/memory/engine.py:251",
    "lane_fetch_cost[p2p]": "graphite_tpu/engine/step.py:253",
    "mem_home_start[ext]": "graphite_tpu/memory/engine.py:2311",
    "shl2_requester": "graphite_tpu/memory/engine_shl2.py:407",
    "shl2_home_start": "graphite_tpu/memory/engine_shl2.py:933",
    "shl2_requester_fill": "graphite_tpu/memory/engine_shl2.py:1141",
}
# the headline's kernels (the memory slice's are MEM_KERNELS)
KERNEL_ORDER = tuple(REPLACES)[:4]
# lane_fetch_cost's lax_p2p instantiation, counted apart
P2P_KERNEL = "lane_fetch_cost[p2p]"
# mem_home_start's instantiation with the MOSI and scheme branches,
# counted apart
HOME_EXT = "mem_home_start[ext]"
# the shared-L2 engine's kernels, in its phase order
SHL2_KERNELS = ("shl2_requester", "shl2_home_start", "shl2_requester_fill")
TIMING_AT = {"send_phase": 200, "receive_phase": 1060}
RUNS = 5

BENCH_CONFIG = """
[general]
total_cores = {n}
mode = lite
max_frequency = 1.0
[network]
user = emesh_hop_counter
memory = emesh_hop_counter
[network/emesh_hop_counter]
flit_width = 64
[network/emesh_hop_counter/router]
delay = 1
[network/emesh_hop_counter/link]
delay = 1
[core/static_instruction_costs]
generic = 1
mov = 1
ialu = 1
imul = 3
falu = 3
fmul = 5
[branch_predictor]
type = one_bit
mispredict_penalty = 14
size = 1024
[clock_skew_management]
scheme = {scheme}
[clock_skew_management/lax_barrier]
quantum = 1000
"""


T0 = time.perf_counter()
_last_phase_t = [T0]


def emit(obj) -> None:
    """One JSON line; a phase's line carries `t_s`, the script's seconds
    so far, and `phase_s`, the seconds since the phase line before it."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "t_s": now - T0, "phase_s": now - _last_phase_t[0]}
        _last_phase_t[0] = now
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --- tensor-tree comparison ----------------------------------------------

def leaves(tree, prefix=""):
    import torch

    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name),
                              f"{prefix}.{f.name}" if prefix else f.name)


def max_abs_err(a, b, what: str) -> int:
    """The largest |a - b| over every leaf of two tensor trees (integer
    and bool leaves, compared as int64); raises on a leaf-set, dtype or
    shape mismatch.  Equal integer trees cost one comparison of all their
    bytes and one host read; the leaves are compared one by one only
    when the bytes differ (or a leaf is a float)."""
    import torch

    la, lb = dict(leaves(a)), dict(leaves(b))
    if la.keys() != lb.keys():
        raise AssertionError(f"{what}: leaf sets differ")
    for name, x in la.items():
        y = lb[name]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what}: {name} dtype/shape differ")

    def flat(tree):
        return torch.cat([t.reshape(-1).view(torch.uint8)
                          for t in tree.values()])

    if la and not any(x.dtype.is_floating_point for x in la.values()):
        xa = flat(la)
        if torch.equal(xa, flat(lb).to(xa.device)):
            return 0
    worst = 0
    for name, x in la.items():
        y = lb[name].to(x.device)
        if not torch.equal(x, y):
            err = int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
            worst = max(worst, err, 1)
            print(f"chip_smoke: {what}: {name} differs (max abs err "
                  f"{err})", file=sys.stderr)
    return worst


# --- the step, unit by unit, each kernel checked against its plain ------

@dataclasses.dataclass
class Ctx:
    params: object
    trace: object
    qend: object
    cost_table: object
    models: object = None      # engine.step.ModelCtx of a memory/iocoom run


def unit_args(name, ctx, st, ln):
    p = ctx.params
    p2p_round = None if p.p2p_slack_ps is None else st.p2p_round
    if name == "lane_fetch_cost":
        return ((ctx.trace, st.core, st.done, st.models_enabled, ctx.qend,
                 ctx.cost_table),
                dict(bp_enabled=p.bp_enabled,
                     bp_penalty=p.bp_mispredict_penalty,
                     syscall_rt_ps=p.syscall_rt_ps, lanes=ln,
                     p2p_slack_ps=p.p2p_slack_ps, p2p_round=p2p_round))
    if name == "user_mailbox":
        return (p.net, ln, st.core.clock_ps, st.models_enabled, st.net), {}
    if name == "noc_route":
        return (p.user_hbh, st.noc_user, ln, st.core.clock_ps,
                st.models_enabled), {}
    if name == "atac_route":
        return (p.user_atac, st.noc_user, ln, st.core.clock_ps,
                st.models_enabled), {}
    if name == "barrier_sync":
        return (ln, st.core.clock_ps, st.sync), {}
    if name == "lane_commit":
        freq_new = ln.freq_new if "dvfs" in p.units else st.core.freq_mhz
        en_post = ln.en_post if "models" in p.units else st.models_enabled
        return ((ctx.trace.op, ln, freq_new, en_post, st.core, st.net,
                 st.done, st.models_enabled, ctx.qend, ctx.cost_table),
                dict(n_follow=p.n_follow(ctx.trace.length),
                     req=None if st.mem is None else st.mem.req,
                     ioc_tile=(None if ctx.models is None
                               else ctx.models.ioc_tile),
                     p2p_round=p2p_round))
    raise KeyError(name)


def stat_key(name, params) -> str:
    """The kernel a unit launches: `lane_fetch_cost[p2p]` under lax_p2p."""
    if name == "lane_fetch_cost" and params.p2p_slack_ps is not None:
        return P2P_KERNEL
    return name


def check_kernel(name, ctx, st, ln, stats) -> None:
    """Run `name`'s plain version on a copy of (state, lanes) and its
    kernel on the originals; every leaf of both must be equal."""
    from graphite_tpu_torch import ops

    st2, ln2 = st.clone(), ln.clone()
    a, k = unit_args(name, ctx, st2, ln2)
    getattr(ops, name + "_plain")(*a, **k)
    a, k = unit_args(name, ctx, st, ln)
    getattr(ops, name)(*a, **k)
    err = max_abs_err(_Pair(st, ln), _Pair(st2, ln2), name)
    key = stat_key(name, ctx.params)
    stats[key]["checks"] += 1
    stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
    if err:
        raise AssertionError(f"{key}: kernel != plain version "
                             f"(max abs err {err})")


@dataclasses.dataclass
class _Pair:
    state: object
    lanes: object


def checked_iteration(ctx, st, ln, stats, sim=None) -> None:
    """`engine.step.subquantum_iteration`, unit by unit in its order, with
    every kernel checked against its plain version (`sim` is needed for
    a run with a memory subsystem or the iocoom core)."""
    from graphite_tpu_torch.engine import step

    units = ctx.params.units
    check_kernel("lane_fetch_cost", ctx, st, ln, stats)
    if ctx.params.mem is not None:
        checked_memory_engine(sim, st, ln, stats)
    if "net" in units:
        if ctx.params.user_hbh is not None:
            check_kernel("noc_route", ctx, st, ln, stats)
        elif ctx.params.user_atac is not None:
            check_kernel("atac_route", ctx, st, ln, stats)
        check_kernel("user_mailbox", ctx, st, ln, stats)
    if "barrier" in units:
        check_kernel("barrier_sync", ctx, st, ln, stats)
    if "mutex" in units:
        step.mutex_cond_unit(ctx.params, st, ln)
    if "pub" in units:
        step.pub_unit(ctx.params, st, ln)
    if "join" in units:
        step.join_unit(st, ln)
    if "dvfs" in units:
        step.dvfs_unit(ctx.params, st, ln)
    if "models" in units:
        step.models_unit(st, ln)
    if ctx.params.iocoom is not None:
        check_mem_kernel("iocoom_commit", sim, st, ln, stats)
    check_kernel("lane_commit", ctx, st, ln, stats)
    if "models" in units:
        st.models_enabled.copy_(ln.en_post)


# --- hand-made edge cases -------------------------------------------------

def edge_cases(sim, stats) -> list:
    """Random and adversarial states at the full width, each kernel
    against its plain version.  Returns the case names."""
    import torch

    from graphite_tpu_torch.trace.schema import Op

    dev = sim.device
    T = sim.params.n_tiles
    D = sim.params.mailbox_depth
    g = torch.Generator(device="cpu").manual_seed(1234)

    def rint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g).to(dtype).to(dev)

    def rbool(p, shape):
        return (torch.rand(shape, generator=g) < p).to(dev)

    base_st, base_ln = sim.state.clone(), sim._lanes.clone()
    ctx = Ctx(sim.params, sim.device_trace,
              torch.tensor(2**61, dtype=torch.int64, device=dev),
              sim._cost_table)
    names = []

    # 1. ANY_SENDER receives with ties + sends into full rings (overflow)
    st, ln = base_st.clone(), base_ln.clone()
    net = st.net
    net.count.copy_(rint(0, D + 1, (T, T), torch.int32))
    net.head.copy_(net.count + rint(0, 3, (T, T), torch.int32))
    net.time_ps.copy_(rint(0, 4, (T, D, T)) * 1000)  # many equal times
    net.lat_ps.copy_(rint(0, 50, (T, D, T), torch.int32))
    op = torch.full((T,), int(Op.NET_RECV), dtype=torch.int32, device=dev)
    op[rbool(0.3, (T,))] = int(Op.SEND)
    ln.op.copy_(op)
    ln.aux0.copy_(torch.where(rbool(0.5, (T,)), -1,
                              rint(0, T, (T,), torch.int32)).to(torch.int32))
    ln.aux1.copy_(rint(-8, 4096, (T,), torch.int32))
    ln.active.copy_(rbool(0.8, (T,)))
    st.core.clock_ps.copy_(rint(0, 5000, (T,)))
    check_kernel("user_mailbox", ctx, st, ln, stats)
    if not bool(st.net.overflow):
        raise AssertionError("edge case: a full ring did not overflow")
    names.append("any_sender_ties+full_ring")

    # 2. barrier-init races, arrivals, releases, split forms
    NB = st.sync.barrier_count.shape[0]
    for rep in range(4):
        st, ln = base_st.clone(), base_ln.clone()
        pool = torch.tensor([int(Op.BARRIER_INIT), int(Op.BARRIER_WAIT),
                             int(Op.BARRIER_ARRIVE), int(Op.BARRIER_SYNC),
                             int(Op.IALU)], dtype=torch.int32, device=dev)
        ln.op.copy_(pool[rint(0, 5, (T,))])
        ln.aux0.copy_(rint(-2, 6, (T,), torch.int32))   # few barriers
        ln.aux1.copy_(rint(-12, 40, (T,), torch.int32))
        ln.active.copy_(rbool(0.9, (T,)))
        ln.done.copy_(rbool(0.05, (T,)))
        st.core.clock_ps.copy_(rint(0, 10_000, (T,)))
        sy = st.sync
        sy.barrier_count.copy_(rint(0, 300, (NB,), torch.int32))
        sy.barrier_arrived.copy_(rint(0, 200, (NB,), torch.int32))
        sy.barrier_time_ps.copy_(rint(0, 9000, (NB,)))
        sy.barrier_waiting.copy_(rbool(0.3, (T,)))
        sy.barrier_gen.copy_(rint(0, 30, (NB,), torch.int32))
        sy.barrier_release_ps.copy_(rint(0, 9000, (NB, 8)))
        check_kernel("barrier_sync", ctx, st, ln, stats)
    names.append("barrier_init_races+split_forms")

    # 3. fetch/cost over every op class, idx at both ends of the row and
    # past it, per-lane frequencies, predictors of 1024 and 1000 entries
    # (mask and remainder), models enabled and disabled, the predictor on
    # and off
    L = sim.device_trace.length
    trace = dataclasses.replace(sim.device_trace)
    ops_pool = torch.tensor(
        [0, 1, 2, 3, 5, 6, 11, 11, 14, 15, 16, 18, 19, 20, 31, 32, 33, 45,
         48, 49, 50, 51, 52, 255], dtype=torch.uint8, device=dev)
    trace.op = ops_pool[rint(0, len(ops_pool), (T, L))].contiguous()
    trace.flags = rint(0, 256, (T, L), torch.uint8)
    trace.pc = rint(0, 2**32, (T, L))
    trace.aux1 = rint(-5, 100_000, (T, L), torch.int32)
    trace.dyn_ps = rint(0, 10**9, (T, L))
    ends = torch.tensor([0, 1, L - 2, L - 1, L, L + 5, -3],
                        dtype=torch.int32, device=dev)
    for bp_size, bp_on, enabled in ((1024, True, True), (1000, True, True),
                                    (1000, False, False),
                                    (1024, True, False)):
        st, ln = base_st.clone(), base_ln.clone()
        st.core.bp_bits = rint(0, 2, (T, bp_size), torch.uint8)
        st.core.idx.copy_(torch.where(
            rbool(0.5, (T,)), ends[rint(0, len(ends), (T,))],
            rint(0, L, (T,), torch.int32)).to(torch.int32))
        st.core.clock_ps.copy_(rint(0, 100_000, (T,)))
        st.core.freq_mhz.copy_(rint(300, 2001, (T,), torch.int32))
        st.done.copy_(rbool(0.1, (T,)))
        st.models_enabled.fill_(enabled)
        ctx3 = Ctx(dataclasses.replace(sim.params, bp_size=bp_size,
                                       bp_enabled=bp_on),
                   trace, torch.tensor(50_000, dtype=torch.int64,
                                       device=dev), sim._cost_table)
        check_kernel("lane_fetch_cost", ctx3, st, ln, stats)
    names.append("fetch_cost_all_op_classes+row_ends+bp_1024_1000")

    # 4. commit: random unit outputs, plain-run batching cut by qend
    plain_ops = torch.tensor([0, 1, 2, 3, 4, 5, 6, 14, 11, 45, 50],
                             dtype=torch.uint8, device=dev)
    trace4 = dataclasses.replace(sim.device_trace)
    trace4.op = plain_ops[rint(0, len(plain_ops), (T, L))].contiguous()
    for en_post in (True, False):
        st, ln = base_st.clone(), base_ln.clone()
        lane_ops = torch.tensor(
            [2, 11, 15, 18, 32, 33, 41, 42, 43, 44, 48, 50, 52, 53, 54],
            dtype=torch.int32, device=dev)
        ln.op.copy_(lane_ops[rint(0, len(lane_ops), (T,))])
        ln.flags.copy_(rint(0, 256, (T,), torch.int32))
        ln.aux0.copy_(rint(-3, 5000, (T,), torch.int32))
        ln.dyn_ps.copy_(rint(0, 60_000, (T,)))
        ln.bp_index.copy_(rint(0, st.core.bp_bits.shape[1], (T,),
                               torch.int32))
        ln.bp_pred.copy_(rint(0, 2, (T,), torch.uint8))
        ln.done.copy_(rbool(0.1, (T,)))
        ln.active.copy_(rbool(0.7, (T,)))
        ln.cost_ps.copy_(rint(0, 20_000, (T,)))
        for f in ("recv_now", "released", "barrive_now", "bsync_now",
                  "granted", "cond_post_commit", "pub_now", "cjoin_now",
                  "join_now"):
            getattr(ln, f).copy_(rbool(0.15, (T,)))
        for f in ("recv_time", "release_time", "bsync_time",
                  "mutex_wait_ps", "cjoin_time", "join_time"):
            getattr(ln, f).copy_(rint(0, 60_000, (T,)))
        ln.recv_lat.copy_(rint(0, 3000, (T,), torch.int32))
        ln.freq_new.copy_(rint(300, 2001, (T,), torch.int32))
        ln.en_post.fill_(en_post)
        st.core.idx.copy_(rint(0, L, (T,), torch.int32))
        st.core.clock_ps.copy_(rint(0, 40_000, (T,)))
        params4 = dataclasses.replace(sim.params,
                                      units=sim.params.units | {"dvfs",
                                                                "models"})
        ctx4 = Ctx(params4, trace4, torch.tensor(
            45_000, dtype=torch.int64, device=dev), sim._cost_table)
        check_kernel("lane_commit", ctx4, st, ln, stats)
    names.append("commit_qend_bound_batching")

    names += mailbox_edge_cases(sim, stats, base_st, base_ln, ctx, rint,
                                rbool)
    names += barrier_edge_cases(dev, stats, rint, rbool)
    names += follow_on_edge_cases(sim, stats, base_st, base_ln, rint,
                                  rbool)
    return names


def mailbox_edge_cases(sim, stats, base_st, base_ln, ctx, rint,
                       rbool) -> list:
    """The one-launch mailbox's corners at full width: every lane an
    ANY_SENDER receiver, all-to-one sends with a named and an ANY_SENDER
    receive of a same-iteration send (ties included), self-sends, and an
    overflow with a pop in one iteration."""
    import torch

    from graphite_tpu_torch.models.network_user import route_latency_ps
    from graphite_tpu_torch.trace.schema import Op

    dev = sim.device
    T = sim.params.n_tiles
    D = sim.params.mailbox_depth
    tiles = torch.arange(T, device=dev, dtype=torch.int32)
    SEND, RECV = int(Op.SEND), int(Op.NET_RECV)
    names = []

    def fresh(count_hi):
        st, ln = base_st.clone(), base_ln.clone()
        net = st.net
        net.count.copy_(rint(0, count_hi, (T, T), torch.int32))
        net.head.copy_(net.count + rint(0, 3, (T, T), torch.int32))
        net.time_ps.copy_(rint(0, 4, (T, D, T)) * 1000)
        net.lat_ps.copy_(rint(0, 50, (T, D, T), torch.int32))
        ln.aux1.copy_(rint(0, 4096, (T,), torch.int32))
        ln.active.fill_(True)
        st.core.clock_ps.copy_(rint(0, 5000, (T,)))
        return st, ln

    # every lane an active ANY_SENDER receiver (16 MB of ring reads)
    for count_hi in (D + 1, 2):
        st, ln = fresh(count_hi)
        ln.op.fill_(RECV)
        ln.aux0.fill_(-1)
        check_kernel("user_mailbox", ctx, st, ln, stats)
    names.append("all_any_sender")

    # all-to-one: every other lane sends to lane 0, which receives the
    # new entry of a named sender (an empty cell before) or takes any
    # sender, where every new send and some old entries tie
    for recv_from in (7, -1):
        st, ln = fresh(2)
        ln.op.fill_(SEND)
        ln.op[0] = RECV
        ln.aux0.fill_(0)
        ln.aux0[0] = recv_from
        net = st.net
        if recv_from >= 0:
            net.count[0, recv_from] = 0
        else:
            v = 10**6
            lat = route_latency_ps(sim.params.net, tiles,
                                   torch.zeros_like(tiles), ln.aux1,
                                   st.models_enabled)
            st.core.clock_ps.copy_(v - lat)
            net.count[0].copy_(rint(0, 2, (T,), torch.int32))
            net.head[0].copy_(net.count[0] + rint(0, 3, (T,), torch.int32))
            tail = torch.fmod(net.head[0] - net.count[0], D).long()
            old = torch.where(rbool(0.5, (T,)), v, v + 1000)
            net.time_ps[0, tail, tiles.long()] = old
        check_kernel("user_mailbox", ctx, st, ln, stats)
        if not bool(ln.recv_now[0]):
            raise AssertionError("edge case: all-to-one receive missed")
    names.append("all_to_one_named+any_sender_ties")

    # self-sends next to receives from self
    st, ln = fresh(D + 1)
    ln.op.copy_(torch.where(tiles % 2 == 0, SEND, RECV).to(torch.int32))
    ln.aux0.copy_(tiles)
    check_kernel("user_mailbox", ctx, st, ln, stats)
    names.append("self_send")

    # odd lane 2k+1 sends into a full ring of lane 2k, which pops it
    st, ln = fresh(D)
    odd = tiles % 2 == 1
    ln.op.copy_(torch.where(odd, SEND, RECV).to(torch.int32))
    ln.aux0.copy_(torch.where(odd, tiles - 1, tiles + 1).to(torch.int32))
    even = torch.arange(0, T - 1, 2, device=dev)
    st.net.count[even, even + 1] = D
    st.net.head[even, even + 1] = D + 1
    check_kernel("user_mailbox", ctx, st, ln, stats)
    if not bool(st.net.overflow):
        raise AssertionError("edge case: overflow+pop did not overflow")
    names.append("overflow_and_pop")
    return names


@dataclasses.dataclass
class BarrierTables:
    """The barrier part of a SyncState (what `barrier_sync` reads)."""

    barrier_count: object
    barrier_arrived: object
    barrier_time_ps: object
    barrier_waiting: object
    barrier_gen: object
    barrier_release_ps: object


@dataclasses.dataclass
class BarrierCall:
    lanes: object
    clock: object
    sync: object

    def clone(self):
        tables = (getattr(self.sync, f.name).clone()
                  for f in dataclasses.fields(self.sync))
        return BarrierCall(self.lanes.clone(), self.clock.clone(),
                           BarrierTables(*tables))


def check_barrier(call, stats) -> "BarrierCall":
    """`barrier_sync` on `call` against its plain version on a copy;
    returns the kernel's result."""
    from graphite_tpu_torch import ops

    ref = call.clone()
    ops.barrier_sync_plain(ref.lanes, ref.clock, ref.sync)
    ops.barrier_sync(call.lanes, call.clock, call.sync)
    err = max_abs_err(call, ref, "barrier_sync")
    stats["barrier_sync"]["checks"] += 1
    stats["barrier_sync"]["max_abs_err"] = max(
        stats["barrier_sync"]["max_abs_err"], err)
    if err:
        raise AssertionError(f"barrier_sync: kernel != plain version "
                             f"(max abs err {err})")
    return call


def barrier_edge_cases(dev, stats, rint, rbool) -> list:
    """`barrier_sync`'s corners, each on its own lanes and tables: the
    lane count T and the barrier count NB vary, so the kernel's stride
    loops, partial warps and table sizes are all reached."""
    import torch

    from graphite_tpu_torch.engine.state import GEN_RING, Lanes
    from graphite_tpu_torch.ops.barrier_sync import MAX_BARRIERS
    from graphite_tpu_torch.trace.schema import Op

    i32 = torch.int32
    INIT, WAIT = int(Op.BARRIER_INIT), int(Op.BARRIER_WAIT)
    ARRIVE, SYNC = int(Op.BARRIER_ARRIVE), int(Op.BARRIER_SYNC)

    def call(T, NB, ops=(INIT, WAIT, ARRIVE, SYNC, int(Op.IALU)),
             n_bars=None, p_active=0.9):
        ln = Lanes.zeros(T, dev)
        pool = torch.tensor(ops, dtype=i32, device=dev)
        ln.op.copy_(pool[rint(0, len(ops), (T,))])
        ln.aux0.copy_(rint(-2, (n_bars or NB) + 2, (T,), i32))
        ln.aux1.copy_(rint(-12, 40, (T,), i32))
        ln.active.copy_(rbool(p_active, (T,)))
        ln.done.copy_(rbool(0.05, (T,)))
        tables = BarrierTables(
            rint(0, 300, (NB,), i32), rint(0, 200, (NB,), i32),
            rint(-5000, 9000, (NB,)), rbool(0.3, (T,)),
            rint(-3, 30, (NB,), i32), rint(0, 9000, (NB, GEN_RING)))
        return BarrierCall(ln, rint(-100, 10_000, (T,)), tables)

    names = []
    # random mixes at every (T, NB) corner: one barrier, the most, lane
    # counts below, at and above the 1024-thread block, not multiples
    # of a warp
    for T, NB in ((1024, 64), (1024, 1), (1024, MAX_BARRIERS), (1000, 64),
                  (37, 5), (1500, 64), (2048, MAX_BARRIERS), (16, 1024)):
        for n_bars in (4, None):
            check_barrier(call(T, NB, n_bars=n_bars), stats)
    names.append("barrier_random_T_NB_corners")

    # every one of 1024 lanes arrives at one barrier: released at once
    # (count 1024) or not (count 2000)
    for cnt in (1024, 2000):
        c = call(1024, 64, ops=(WAIT,), p_active=1.0)
        c.lanes.aux0.fill_(3)
        c.lanes.done.fill_(False)
        c.sync.barrier_waiting.fill_(False)
        c.sync.barrier_count[3] = cnt
        c.sync.barrier_arrived[3] = 0
        r = check_barrier(c, stats)
        if bool(r.lanes.released.all()) != (cnt == 1024):
            raise AssertionError("edge case: 1024 arrivals at one barrier")
    names.append("all_lanes_one_barrier")

    # several barriers release in one iteration: barrier b gets exactly
    # count(b) arrivals, b in 0..7, from lanes spread over a warp each
    c = call(1024, 64, ops=(WAIT, ARRIVE), p_active=1.0)
    lane = torch.arange(1024, device=dev, dtype=i32)
    c.lanes.aux0.copy_(lane % 8)
    c.lanes.done.fill_(False)
    c.sync.barrier_waiting.fill_(False)
    c.sync.barrier_count[:8] = 128
    c.sync.barrier_arrived[:8] = 0
    r = check_barrier(c, stats)
    if int((r.sync.barrier_arrived[:8] == 0).sum()) != 8:
        raise AssertionError("edge case: eight releases in one iteration")
    names.append("several_releases")

    # many tiles init one barrier with different, negative counts: the
    # lowest active initialising tile's count wins
    c = call(1024, 64, ops=(INIT,), p_active=0.7)
    c.lanes.aux0.fill_(5)
    c.lanes.aux1.copy_(rint(-1000, 1000, (1024,), i32))
    r = check_barrier(c, stats)
    first = int(torch.nonzero(c.lanes.active)[0])
    if int(r.sync.barrier_count[5]) != int(c.lanes.aux1[first]):
        raise AssertionError("edge case: init election")
    names.append("init_race_negative_counts")

    # BARRIER_SYNC across the ring's wrap: barrier 2 releases into
    # generation 16 (slot 0) while lanes wait on generations 8..24
    c = call(1024, 64, ops=(SYNC,), p_active=1.0)
    c.lanes.aux0.fill_(2)
    c.lanes.aux1.copy_(rint(-9, 25, (1024,), i32))
    c.lanes.op[:4] = ARRIVE
    c.lanes.active[:4] = True
    c.sync.barrier_count[2], c.sync.barrier_arrived[2] = 4, 0
    c.sync.barrier_gen[2] = 15
    r = check_barrier(c, stats)
    if int(r.sync.barrier_gen[2]) != 16:
        raise AssertionError("edge case: ring wrap did not release")
    names.append("sync_ring_wrap")

    # no active barrier op (the gate is false) over non-zero tables, a
    # negative time at barrier 0; then the same with a barrier already due
    for due in (False, True):
        c = call(1024, 64, ops=(WAIT, INIT, SYNC, int(Op.SEND)),
                 p_active=0.0)
        c.lanes.op[::3] = int(Op.SEND)
        c.lanes.active[::3] = True
        c.sync.barrier_time_ps[0] = -77
        c.sync.barrier_count.clamp_(min=1)
        c.sync.barrier_arrived.copy_(c.sync.barrier_count - 1)
        if due:
            c.sync.barrier_arrived[9] = c.sync.barrier_count[9]
        r = check_barrier(c, stats)
        if int(r.sync.barrier_time_ps[0]) != 0:
            raise AssertionError("edge case: idle max(time[0], 0)")
    names.append("idle_tables+barrier_already_due")
    return names


def follow_on_state(sim, base_st, base_ln, rint, rbool, plain_ops, freqs,
                    qend: int, en_post: bool, near_end: float):
    """(ctx, state, lanes) of a lane_commit call where every lane is at a
    PLAIN record (so it advances) and its follow-on window holds records
    drawn from `plain_ops`, at a post-DVFS frequency drawn from `freqs`;
    a share `near_end` of the lanes sits within a window of the row's
    end."""
    import torch

    dev = sim.device
    T = sim.params.n_tiles
    L = sim.device_trace.length
    pool = torch.tensor(plain_ops, dtype=torch.uint8, device=dev)
    trace = dataclasses.replace(sim.device_trace)
    trace.op = pool[rint(0, len(pool), (T, L))].contiguous()
    freqs = torch.tensor(freqs, dtype=torch.int32, device=dev)
    params = dataclasses.replace(sim.params,
                                 units=sim.params.units | {"dvfs",
                                                           "models"})
    st, ln = base_st.clone(), base_ln.clone()
    ln.op.copy_(rint(0, 7, (T,), torch.int32))     # PLAIN: advance
    ln.active.copy_(rbool(0.95, (T,)))
    ln.cost_ps.copy_(rint(0, 3000, (T,)))
    ln.freq_new.copy_(freqs[rint(0, len(freqs), (T,))])
    ln.en_post.fill_(en_post)
    st.core.idx.copy_(torch.where(
        rbool(near_end, (T,)), rint(L - 17, L + 2, (T,)),
        rint(0, L - 17, (T,))).to(torch.int32))
    st.core.clock_ps.copy_(rint(0, 25_000, (T,)))
    ctx = Ctx(params, trace, torch.tensor(qend, dtype=torch.int64,
                                          device=dev), sim._cost_table)
    return ctx, st, ln


def follow_on_edge_cases(sim, stats, base_st, base_ln, rint,
                         rbool) -> list:
    """lane_commit's follow-on windows at full width: windows that run
    into the end of the trace row or are cut by qend or by a non-PLAIN
    record, under per-lane post-DVFS frequencies, with models enabled
    and disabled."""
    plain_ops = [0, 1, 2, 3, 4, 5, 6, 7, 14, 2, 2, 11, 50, 15]
    freqs = [1000, 1000, 1000, 333, 2000, 1500]
    for qend in (2**61, 30_000):
        for en_post in (True, False):
            ctx, st, ln = follow_on_state(sim, base_st, base_ln, rint,
                                          rbool, plain_ops, freqs, qend,
                                          en_post, 0.6)
            check_kernel("lane_commit", ctx, st, ln, stats)
    return ["follow_on_row_end+qend+per_lane_freq"]


def follow_on_timing_state(sim):
    """The state `lane_commit` is timed at beside the FFT's: every lane
    commits a full window of KX PLAIN records at one frequency, well
    before qend (the FFT commits none)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(99)
    dev = sim.device

    def rint(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g).to(dtype).to(dev)

    def rbool(p, shape):
        return (torch.rand(shape, generator=g) < p).to(dev)

    return follow_on_state(sim, sim.state, sim._lanes, rint, rbool,
                           [0, 1, 2, 3, 4, 5, 6, 7, 14], [1000], 2**61,
                           True, 0.0)


# --- timing and bounds ----------------------------------------------------

def time_ms(fn, n: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = 100, reps: int = 5) -> float:
    """Device time of one call: `n` calls captured in a CUDA graph and
    replayed `reps` times between CUDA events, so host overhead (Python,
    argument checks, ctypes) is out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def bound(name, sim, st, ln) -> tuple[float, str, int, int]:
    """(bound_ms, bound_by, bytes, ops) of one call at this state: each
    input byte the function needs read once, each output written once,
    counted from this state's data."""
    from graphite_tpu_torch.trace.schema import Op

    T = sim.params.n_tiles
    op, act = ln.op, ln.active
    n = lambda m: int(m.sum())  # noqa: E731
    if name == "lane_fetch_cost":
        # record 26 B + idx/clock/freq/done 17 B + predictor byte; outputs
        # op/flags/pc/aux0/aux1/dyn/bp_index/bp_pred/done/active/cost
        nbytes = T * (26 + 17 + 1 + 47) + 20 * 8 + 9
        ops = T * 40
        if sim.params.p2p_slack_ps is not None:
            # the partner's idx, clock, done and op, and the round counter
            nbytes += T * (4 + 8 + 1 + 1) + 4
            ops += T * 12
    elif name == "user_mailbox":
        sends = n(act & (op == int(Op.SEND)))
        recv = act & (op == int(Op.NET_RECV))
        any_r = n(recv & (ln.aux0 == -1))
        named = n(recv) - any_r
        nbytes = (T * (4 + 4 + 4 + 1 + 8) + sends * (8 + 20)
                  + named * (20 + 4) + any_r * (T * 16 + 8)
                  + T * (1 + 8 + 4))
        ops = T * 30 + any_r * T * 4
    elif name == "barrier_sync":
        NB = st.sync.barrier_count.shape[0]
        nbytes = T * (23 + 20) + NB * (20 + 20)
        ops = T * 30 + NB * 10
    elif name == "lane_commit":
        lane_in = 25 * 1 + 4 * 4 + 8 * 8 + 4 + 1   # flags/ints/times/...
        core_rw = 2 * (10 * 8 + 2 * 4) + 2 * 3 * 8
        follow = int(sim.params.n_follow(sim.device_trace.length))
        nbytes = T * (lane_in + core_rw + follow) + 20 * 8
        ops = T * (60 + 6 * follow)
    else:
        raise KeyError(name)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return ((t_bytes, "bytes", nbytes, ops) if t_bytes >= t_ops
            else (t_ops, "operations", nbytes, ops))


def time_kernels(sim, ctx, st, ln, names=KERNEL_ORDER) -> dict:
    """Each kernel of `names` and its plain version at this state (main-
    path shapes), on copies, in the step's order."""
    from graphite_tpu_torch import ops

    out = {}
    for name in names:
        kernel = ops.KERNELS[stat_key(name, ctx.params)]
        timers = [("ms", name, graph_ms),
                  ("call_ms", name, lambda f: time_ms(f, 200)),
                  ("plain_ms", name + "_plain", lambda f: time_ms(f, 20))]
        timers.append(("call_unbound_ms", name,
                       lambda f: time_ms(unbound(f, kernel), 200)))
        res = {}
        for impl, fn_name, timer in timers:
            s2, l2 = st.clone(), ln.clone()
            a, k = unit_args(name, ctx, s2, l2)
            fn = getattr(ops, fn_name)
            res[impl] = timer(lambda: fn(*a, **k))
        b_ms, b_by, nbytes, nops = bound(name, sim, st, ln)
        res.update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=nops)
        out[name] = res
        # advance the state through this unit, as the step would
        a, k = unit_args(name, ctx, st, ln)
        getattr(ops, name)(*a, **k)
    return out


def unbound(fn, kernel):
    """`fn` with the kernel's binding dropped before every call: each
    call validates and packs every argument, as every call did before
    the bound launch path."""
    def call():
        kernel.binding = None
        fn()
    return call


def sim_qend(sim):
    import torch

    return torch.tensor(2**61, dtype=torch.int64, device=sim.device)


# --- phases ---------------------------------------------------------------

def make_sim(n_tiles, batch, device, scheme="lax", extra="", **kw):
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator

    sc = SimConfig(ConfigFile.from_string(
        BENCH_CONFIG.format(n=n_tiles, scheme=scheme) + extra))
    return Simulator(sc, batch, device=device, **kw)


RESULT_FIELDS = (
    "n_tiles", "completion_time_ps", "instruction_count", "clock_ps",
    "memory_stall_ps", "execution_stall_ps", "recv_instructions",
    "recv_stall_ps", "sync_instructions", "sync_stall_ps", "bp_correct",
    "bp_incorrect", "packets_sent", "packets_received",
    "total_packet_latency_ps", "n_quanta", "mem_counters", "func_errors",
    "detailed_stalls", "telemetry", "profile", "hist")


def at_barrier(ln) -> bool:
    """Whether at least half the lanes are active at BARRIER_WAIT."""
    from graphite_tpu_torch.trace.schema import Op

    n = int((ln.active & (ln.op == int(Op.BARRIER_WAIT))).sum())
    return 2 * n >= ln.op.shape[0]


def phase_kernels(dev, batch, stats) -> dict:
    """Phase 3 at T = 1024: checked iterations of the full-width FFT, the
    edge cases, and timings at a send-phase, a receive-phase and a
    barrier-phase state (the first iteration found at a barrier)."""
    import torch

    sim = make_sim(1024, batch, dev, inner_block=64)
    ctx = Ctx(sim.params, sim.device_trace, sim_qend(sim), sim._cost_table)
    st, ln = sim.state, sim._lanes
    n_checked = 1100            # barrier init + release, sends, receives
    at = {i: phase for phase, i in TIMING_AT.items()}
    timings = {}
    barrier_at = None
    t0 = time.perf_counter()
    for i in range(n_checked):
        if i in at:
            timings[at[i]] = time_kernels(sim, ctx, st.clone(), ln.clone())
        before = (st.clone(), ln.clone()) if barrier_at is None else None
        checked_iteration(ctx, st, ln, stats)
        if barrier_at is None and at_barrier(ln):
            barrier_at = i
            timings["barrier_phase"] = time_kernels(sim, ctx, *before)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    if barrier_at is None:
        raise AssertionError("no checked iteration has half the lanes at "
                             "BARRIER_WAIT")
    cases = edge_cases(sim, stats)
    fctx, fst, fln = follow_on_timing_state(sim)
    timings["follow_on"] = time_kernels(sim, fctx, fst, fln,
                                        ("lane_commit",))
    torch.cuda.synchronize()
    return {"iterations_checked": n_checked, "checked_s": checked_s,
            "barrier_phase_at": barrier_at, "edge_cases": cases,
            "timings": timings}


def phase_end_to_end(dev, card: str) -> None:
    import numpy as np

    from graphite_tpu_torch.trace import synthetic
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    cases = [
        ("fft64_lax", 64, fft_trace(64), "lax"),
        ("fft64_lax_barrier", 64, fft_trace(64, points_per_tile=64),
         "lax_barrier"),
        ("fft256_lax", 256, fft_trace(256), "lax"),
        ("ring64_lax", 64, synthetic.message_ring_batch(
            64, 16, compute_per_round=40), "lax"),
    ]
    for name, n, batch, scheme in cases:
        res = {}
        for where in (dev, "cpu"):
            sim = make_sim(n, batch, where, scheme=scheme, inner_block=32)
            t0 = time.perf_counter()
            r = sim.run()
            res[str(where)] = (r, sim.last_n_iterations,
                               time.perf_counter() - t0)
        (rc, ic, wc), (rp, ip, wp) = res[str(dev)], res["cpu"]
        bad = [f for f in RESULT_FIELDS
               if not field_equal(getattr(rc, f), getattr(rp, f))]
        if ic != ip:
            bad.append("last_n_iterations")
        row = {"case": name, "card": card, "tiles": n, "equal": not bad,
               "bad": bad,
               "n_quanta": rc.n_quanta, "iterations": ic,
               "card_s": wc, "cpu_s": wp,
               "total_instructions": rc.total_instructions}
        emit({"phase": "end_to_end", **row})
        if bad:
            raise AssertionError(f"card != cpu on {name}: {bad}")


def field_equal(a, b) -> bool:
    import numpy as np

    if a is None or b is None:
        return a is b
    return bool(np.array_equal(a, b))


def trace_instructions(batch) -> int:
    """Instructions a trace itself fixes: instruction records (static,
    branch, dynamic but SPAWN) plus BBLOCK instruction counts."""
    import numpy as np

    from graphite_tpu_torch.trace.schema import Op

    op = np.asarray(batch.op)
    instr = (op < 20) & (op != int(Op.SPAWN))
    bblock = op == int(Op.BBLOCK)
    return int(instr.sum()) + int(np.asarray(batch.aux0)[bblock]
                                  .astype(np.int64).sum())


def phase_full_width(dev, batch) -> dict:
    """The headline: warmup, then RUNS timed runs from one initial state,
    each with every launch count set to 0 just before it and read just
    after; `user_mailbox` and `lane_commit` must launch exactly once per
    iteration.  Returns the last run's numbers and every run's wall."""
    import torch

    from graphite_tpu_torch import ops

    sim = make_sim(1024, batch, dev, inner_block=64)
    # the initial state, kept off the card (not in the peak memory)
    init = sim.state._map(lambda t: t.to("cpu", copy=True))
    t0 = time.perf_counter()
    sim.warmup()
    warm_s = time.perf_counter() - t0
    walls, packs = [], []
    for _ in range(RUNS):
        sim.state = init._map(lambda t: t.to(dev, copy=True))
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = sim.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        packs.append(ops.pack_counts())
        iters = sim.last_n_iterations
        missing = [k for k in KERNEL_ORDER if counts[k] <= 0]
        if missing:
            raise AssertionError(f"main path never launched {missing}")
        off = {k: counts[k] for k in KERNEL_ORDER if counts[k] != iters}
        if off:
            raise AssertionError(f"{off} launches in {iters} iterations: "
                                 "expected one a call, one call an "
                                 "iteration")
        repacked = {k: n for k, n in packs[-1].items() if n > 1}
        if repacked:
            raise AssertionError(f"{repacked} packs in one run: expected "
                                 "at most one a kernel")
    if not bool(sim.state.done.all()):
        raise AssertionError("full width: not every tile is done")
    expect = (trace_instructions(batch) + int(r.recv_instructions.sum())
              + int(r.sync_instructions.sum()))
    if r.total_instructions != expect:
        raise AssertionError(f"full width: {r.total_instructions} "
                             f"instructions, trace implies {expect}")
    med = sorted(walls)[len(walls) // 2]
    return {
        "tiles": 1024, "points_per_tile": 2048, "runs": RUNS,
        "wall_s": walls, "wall_s_median": med,
        "wall_s_min": min(walls), "wall_s_max": max(walls),
        "warmup_s": warm_s,
        "sim_instr_per_s_median": r.total_instructions / med,
        "sim_instr_per_s": [r.total_instructions / w for w in walls],
        "us_per_iteration_median": med / sim.last_n_iterations * 1e6,
        "total_instructions": r.total_instructions,
        "completion_time_ps": r.completion_time_ps,
        "iterations": sim.last_n_iterations, "n_quanta": r.n_quanta,
        "mailbox_depth": sim.params.mailbox_depth,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "launches": counts, "packs": packs,
    }, sim, init


PROFILE_WARMUP = 8          # iterations the profiler's warm-up step runs


def checked_profile(sim, init, start: int, wall_per_iter_s: float, names,
                    slack: int, what: str, per_call=None) -> dict:
    """`phase_profile`, and the check that each kernel of `names` made one
    device launch a call (`per_call[name]` for a kernel that launches more
    than once an iteration): each launched within `slack` calls of the
    window's iterations (launches the device trace drops at the window's
    start), and no more."""
    prof = phase_profile(sim, init, start, wall_per_iter_s)
    n = prof["iterations"]
    bad = {}
    for name in names:
        k = (per_call or {}).get(name, 1)
        one = [v["launches"] for k_, v in prof["kernels"].items()
               if is_kernel(k_, name)]
        if len(one) != 1 or not k * (n - slack) <= one[0] <= k * n:
            bad[name] = one
    if bad:
        raise AssertionError(f"{what}: device launches {bad} in {n} calls")
    return prof


def phase_profile(sim, init, start: int, wall_per_iter_s: float) -> dict:
    """torch.profiler over one `inner_block` of the headline run, from
    iteration `start`: kernel device time and launches by name, and the
    device's busy share of the window's wall time (the profiler slows
    the host, so the share of the unprofiled run's wall is given too)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from graphite_tpu_torch.engine.step import subquantum_iteration

    sim.state = init._map(lambda t: t.to(sim.device, copy=True))
    qend = sim_qend(sim)
    n = sim.params.inner_block

    def block(k):
        for _ in range(k):
            subquantum_iteration(sim.params, sim.device_trace, sim.state,
                                 qend, sim._lanes, sim._cost_table,
                                 sim.models)
        int(sim._lanes.progress.item())      # the loop's one host read

    pre = min(PROFILE_WARMUP, start)
    block(start - pre)
    torch.cuda.synchronize()
    # the device trace can miss the first launches after the profiler
    # starts: a warm-up step (the `pre` iterations before the window)
    # starts the tracer and is discarded; the active step is the window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                  active=1, repeat=1)
                 ) as prof:
        torch.ones(1, device=sim.device).add_(1)
        block(pre)
        torch.cuda.synchronize()
        prof.step()
        # one small op and a pause before the window: the tracer has lost
        # most of a window launched right after it started
        torch.ones(1, device=sim.device).add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        block(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies): a host op that
        # launched one carries its device time too, and the schedule's
        # step annotation spans the window without being device work
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith("ProfilerStep")):
            continue
        dev_us = e.self_device_time_total
        kernels[e.key] = {"launches": e.count, "device_us": dev_us,
                          "device_us_per_launch": dev_us / e.count}
    busy_us = sum(k["device_us"] for k in kernels.values())
    return {"iterations": n, "from_iteration": start, "wall_s": wall,
            "device_busy_us": busy_us,
            "busy_share": busy_us * 1e-6 / wall if busy_us else None,
            "busy_share_of_unprofiled_wall": (
                busy_us * 1e-6 / (wall_per_iter_s * n) if busy_us else None),
            "kernels": kernels}


# --- the memory slice: the 64-tile iocoom + MSI FFT companion -------------

MEM_KERNELS = ("mem_requester", "mem_home_start", "mem_requester_fill",
               "iocoom_commit")
COMPANION_POINTS = 512
COMPANION_CHECKED = 129     # of the companion's 768 iterations (its
#                             first miss-heavy state is iteration 128)
STRESS_CHECKED = 150        # of the 64-tile memstress run's iterations
MEM_RUNS = 5                # odd: the median is one run's wall
TINY_L2 = "[l2_cache/T1]\ncache_size = 4\nassociativity = 1\n"
TINY_DIR = "[dram_directory]\ntotal_entries = 32\nassociativity = 2\n"
ROUND_ROBIN = ("[l1_dcache/T1]\nreplacement_policy = round_robin\n"
               "[l2_cache/T1]\nreplacement_policy = round_robin\n")
UNROLL4 = "[general]\nrequester_unroll = 4\n"


def mem_sim(n_tiles, batch, device, *, core="simple", network=None,
            extra="", clock_scheme="lax", inner_block=64):
    """A run of the memory slice: the benchmark scripts' config text
    (graphite_tpu_torch/config/template.py) with shared memory on."""
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.config.template import config_text
    from graphite_tpu_torch.engine.simulator import Simulator

    kw = {} if network is None else {"network": network}
    text = config_text(n_tiles, core=core, shared_mem=True,
                       clock_scheme=clock_scheme, **kw) + extra
    return Simulator(SimConfig(ConfigFile.from_string(text)), batch,
                     device=device, inner_block=inner_block)


def companion(device, points=COMPANION_POINTS):
    """bench.py's coherence companion: 64 iocoom tiles, MSI full_map,
    emesh_hop_counter, lax, the FFT with its private loads."""
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    return mem_sim(64, fft_trace(64, points_per_tile=points,
                                 use_memory=True), device, core="iocoom")


def memstress(n_tiles, device, n_accesses=40, extra=""):
    """The coherence stress workload (shared_fraction 0.5, write_fraction
    0.4): requests, evictions, INV/FLUSH/WB fan-outs, acks."""
    from graphite_tpu_torch.trace import synthetic

    return mem_sim(n_tiles, synthetic.memory_stress_trace(
        n_tiles, n_accesses=n_accesses, working_set_bytes=1 << 13,
        write_fraction=0.4, shared_fraction=0.5, seed=7), device,
        extra=extra)


def one_word_batch():
    """Five tiles store to five lines that share one functional word (256
    KB apart) in one iteration, twice (cold: the stores complete in the
    fill phase; warm: in the requester phase), and tile 0 checks that the
    word holds the highest tile's value."""
    from graphite_tpu_torch.trace.schema import TraceBatch, TraceBuilder

    bs = [TraceBuilder() for _ in range(5)]
    bs[0].barrier_init(0, 5)
    for b in bs:
        b.barrier_wait(0)
    base = 0x100000
    for r in range(2):
        for t, b in enumerate(bs):
            b.store_value(base + t * (256 << 10), 10 * r + t + 1)
        for b in bs:
            b.barrier_wait(0)
        bs[0].load_check(base, 10 * r + 5)
        for b in bs:
            b.barrier_wait(0)
    return TraceBatch.from_builders(bs)


def mem_call(name, sim, st, ln, plain: bool) -> None:
    """One call of a memory-slice kernel on (st, ln): its wrapper, or its
    plain version (on the same device)."""
    import torch

    from graphite_tpu_torch import ops
    from graphite_tpu_torch.memory.context import MemRec
    from graphite_tpu_torch.ops.iocoom_commit import iocoom_inputs

    ctx, core, en = sim.models.mem, st.core, st.models_enabled
    tr = sim.device_trace
    if name == "iocoom_commit":
        lat = None if st.mem is None else st.mem.req.slot_lat_ps
        if plain:
            regs, addrs, lat = iocoom_inputs(core, tr, lat)
            ops.iocoom_commit_plain(sim.params.iocoom, st.ioc, ln,
                                    sim.models.ioc_tile, core.clock_ps,
                                    core.freq_mhz, regs, addrs, lat, en)
        else:
            ops.iocoom_commit(sim.params.iocoom, st.ioc, ln,
                              sim.models.ioc_tile, core, tr, lat, en)
    elif name == "mem_home_start":
        fn = ops.mem_home_start_plain if plain else ops.mem_home_start
        fn(ctx, st.mem, en, ln.progress)
    elif name == "shl2_requester":
        if plain:
            ops.shl2_requester_plain(
                ctx, st.mem, MemRec.fetch(ln, tr, core.idx), core.clock_ps,
                core.freq_mhz.to(torch.int64), ln.active, en, ln.progress)
        else:
            ops.shl2_requester(ctx, st.mem, ln, tr, core, en, ln.progress)
    elif name == "shl2_home_start":
        if plain:
            ops.shl2_home_start_plain(
                ctx, st.mem, ctx.cycle_ps(core.freq_mhz, en), en,
                ln.progress)
        else:
            ops.shl2_home_start(ctx, st.mem, core.freq_mhz, en, ln.progress)
    elif name == "shl2_requester_fill":
        if plain:
            ops.shl2_requester_fill_plain(
                ctx, st.mem, MemRec.fetch(ln, tr, core.idx), core.clock_ps,
                core.freq_mhz.to(torch.int64), en, ln.progress, ln.mem_ok)
        else:
            ops.shl2_requester_fill(ctx, st.mem, ln, tr, core, en,
                                    ln.progress, ln.mem_ok)
    elif name == "mem_requester":
        if plain:
            ops.mem_requester_plain(
                ctx, st.mem, MemRec.fetch(ln, tr, core.idx), core.clock_ps,
                core.freq_mhz.to(torch.int64), ln.active, en, ln.progress)
        else:
            ops.mem_requester(ctx, st.mem, ln, tr, core, en, ln.progress)
    elif name == "mem_requester_fill":
        if plain:
            ops.mem_requester_fill_plain(
                ctx, st.mem, MemRec.fetch(ln, tr, core.idx), core.clock_ps,
                core.freq_mhz.to(torch.int64), en, ln.progress, ln.mem_ok)
        else:
            ops.mem_requester_fill(ctx, st.mem, ln, tr, core, en,
                                   ln.progress, ln.mem_ok)
    else:
        raise KeyError(name)


def mem_stat_key(name, sim) -> str:
    """The kernel a memory unit launches: `mem_home_start[ext]` under
    MOSI or a limited directory scheme."""
    import importlib

    mod = importlib.import_module("graphite_tpu_torch.ops.mem_home_start")
    if name == "mem_home_start" and hasattr(mod, "kernel_for"):
        # (`--ab` also runs trees from before the second entry point)
        return mod.kernel_for(sim.models.mem).name
    return name


def check_mem_kernel(name, sim, st, ln, stats) -> None:
    """`name`'s plain version on a copy of (state, lanes), its kernel on
    the originals; every leaf of both must be equal."""
    st2, ln2 = st.clone(), ln.clone()
    mem_call(name, sim, st2, ln2, plain=True)
    mem_call(name, sim, st, ln, plain=False)
    key = mem_stat_key(name, sim)
    err = max_abs_err(_Pair(st, ln), _Pair(st2, ln2), key)
    stats[key]["checks"] += 1
    stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], err)
    if err:
        raise AssertionError(f"{key}: kernel != plain version "
                             f"(max abs err {err})")


def checked_memory_engine(sim, st, ln, stats) -> None:
    """`memory.engine.memory_engine_step` as the card runs it (phases 2
    and 4-5 as the replays of its two CUDA graphs), its three kernels
    checked against their plain versions, and under a contention net the
    graph of phases 4-5 against the same phases routed by the plain
    version of `mem_net_route`."""
    mctx, en = sim.models.mem, st.models_enabled
    graphs = mctx.phase_graphs
    if sim.params.mem.is_shl2:
        # the shared-L2 engine: phases 2-4 as the replay of its graph
        (middle,) = graphs.get(mctx, st.mem, en, st.core.freq_mhz,
                               ln.progress)
        check_mem_kernel("shl2_requester", sim, st, ln, stats)
        if st.mem.noc is None:
            graphs.replay(middle)
        else:
            check_route_phases(sim, st, ln, stats, middle)
        check_mem_kernel("shl2_home_start", sim, st, ln, stats)
        check_mem_kernel("shl2_requester_fill", sim, st, ln, stats)
        return
    evict, sharer_acks = graphs.get(mctx, st.mem, en, st.core.freq_mhz,
                                    ln.progress)
    check_mem_kernel("mem_requester", sim, st, ln, stats)
    graphs.replay(evict)
    check_mem_kernel("mem_home_start", sim, st, ln, stats)
    if st.mem.noc is None:
        graphs.replay(sharer_acks)
    else:
        check_route_phases(sim, st, ln, stats, sharer_acks)
    check_mem_kernel("mem_requester_fill", sim, st, ln, stats)


def check_route_phases(sim, st, ln, stats, sharer_acks) -> None:
    """Phases 4 and 5 (the shared-L2 engine: phases 2-4) under a
    contention MEMORY net: on a copy with their routes through the plain
    version of `mem_net_route`, on the originals as the replay of their
    CUDA graph (`sharer_acks`, two `mem_net_route` launches); every leaf
    of both must be equal."""
    import importlib

    from graphite_tpu_torch.memory import engine as me

    mnr = importlib.import_module("graphite_tpu_torch.ops.mem_net_route")
    mctx = sim.models.mem
    st2, ln2 = st.clone(), ln.clone()
    en2 = st2.models_enabled
    orig, mnr.mem_net_route = mnr.mem_net_route, mnr.mem_net_route_plain
    try:
        if sim.params.mem.is_shl2:
            # the shared-L2 engine's graph: its phases 2-4
            from graphite_tpu_torch.memory.engine_shl2 import (
                shl2_graph_phases,
            )

            shl2_graph_phases(mctx, en2, st2.core.freq_mhz)[0](
                st2.mem, ln2.progress)
        else:
            me.sharer_step(mctx, st2.mem,
                           mctx.cycle_ps(st2.core.freq_mhz, en2), en2,
                           ln2.progress)
            me.home_acks_and_finish(mctx, st2.mem, en2, ln2.progress)
    finally:
        mnr.mem_net_route = orig
    mctx.phase_graphs.replay(sharer_acks)
    err = max_abs_err(_Pair(st, ln), _Pair(st2, ln2), "mem_net_route")
    stats["mem_net_route"]["checks"] += 1
    stats["mem_net_route"]["max_abs_err"] = max(
        stats["mem_net_route"]["max_abs_err"], err)
    if err:
        raise AssertionError(f"mem_net_route: kernel != plain version "
                             f"(max abs err {err})")


def sim_ctx(sim):
    return Ctx(sim.params, sim.device_trace, sim_qend(sim), sim._cost_table,
               sim.models)


def miss_heavy(sim, st) -> bool:
    """Whether at least half the lanes, idle, stand at a record with a
    memory operand (the companion's cold loads)."""
    import torch

    from graphite_tpu_torch.trace.schema import FLAG_MEM0_VALID

    tr = sim.device_trace
    col = torch.clamp(st.core.idx, max=tr.length - 1).to(torch.int64)
    flags = torch.gather(tr.flags, 1, col[:, None])[:, 0]
    n = int(((flags & FLAG_MEM0_VALID) != 0)
            .logical_and(st.mem.req.phase == 0).logical_and(~st.done).sum())
    return 2 * n >= st.done.shape[0]


def run_checked(sim, n_max, stats, on_state=None) -> int:
    """Up to `n_max` checked iterations of `sim` (lax: one quantum), or
    until every tile is done; `on_state(i, st, ln)` sees the state
    before iteration i.  Returns the iterations run."""
    ctx = sim_ctx(sim)
    st, ln = sim.state, sim._lanes
    for i in range(n_max):
        if on_state is not None:
            on_state(i, st, ln)
        checked_iteration(ctx, st, ln, stats, sim=sim)
        if bool(st.done.all()):
            return i + 1
    return n_max


def mem_edge_cases(dev, stats) -> dict:
    """Hand-made states of the memory slice, every iteration checked.
    Returns each case's iterations and the counter that shows its path
    was taken."""
    import torch

    from graphite_tpu_torch.trace import synthetic

    out = {}

    def total(sim, name):
        return int(getattr(sim.state.mem.counters, name).sum())

    sim = memstress(16, dev, n_accesses=60, extra=TINY_L2)
    out["dirty_l2_victim"] = {"iterations": run_checked(sim, 2000, stats),
                              "dram_writes": total(sim, "dram_writes")}
    sim = memstress(16, dev, n_accesses=60, extra=TINY_DIR)
    out["nullify_with_sharers"] = {
        "iterations": run_checked(sim, 2000, stats),
        "dir_accesses": total(sim, "dir_accesses"),
        "l2_misses": total(sim, "l2_misses")}
    sim = memstress(16, dev, n_accesses=60, extra=ROUND_ROBIN)
    out["line_minus_one_round_robin"] = {
        "iterations": run_checked(sim, 2000, stats),
        "evictions": total(sim, "evictions")}
    sim = mem_sim(16, synthetic.memory_stress_trace(
        16, n_accesses=60, working_set_bytes=1 << 9, write_fraction=0.3,
        seed=3), dev, extra=UNROLL4)
    out["requester_unroll_4"] = {"iterations": run_checked(sim, 2000, stats),
                                 "l1d_hits": total(sim, "l1d_read_hits")
                                 + total(sim, "l1d_write_hits")}
    sim = mem_sim(5, one_word_batch(), dev, network="magic")
    out["two_lanes_one_word"] = {
        "iterations": run_checked(sim, 2000, stats),
        "func_errors": int(sim.state.mem.func_errors)}
    sim = memstress(1024, dev, n_accesses=6)
    out["tiles_1024_sw32"] = {"iterations": run_checked(sim, 60, stats),
                              "sharer_words": sim.params.mem.sharer_words}
    del sim
    torch.cuda.empty_cache()
    # each case's counter must show that its path was taken
    shown = {"dirty_l2_victim": "dram_writes",
             "nullify_with_sharers": "dir_accesses",
             "line_minus_one_round_robin": "evictions",
             "requester_unroll_4": "l1d_hits",
             "tiles_1024_sw32": "iterations"}
    bad = [k for k, n in shown.items() if out[k][n] <= 0]
    if out["nullify_with_sharers"]["dir_accesses"] <= out[
            "nullify_with_sharers"]["l2_misses"]:
        bad.append("nullify_with_sharers: no NULLIFY")
    if out["two_lanes_one_word"]["func_errors"] != 0:
        bad.append("two_lanes_one_word: the word lost the highest lane")
    if bad:
        raise AssertionError(f"memory edge cases missed their path: {bad}")
    return out


def kernel_tensors(name, sim, ctx, st, ln) -> list:
    """The tensors a call of `name` binds at (st, ln)."""
    import importlib

    mod = importlib.import_module(f"graphite_tpu_torch.ops.{name}")
    core, en = st.core, st.models_enabled
    if name == "lane_commit":
        a, k = unit_args(name, ctx, st, ln)
        args = mod.bound_args(*a, k["n_follow"], k["req"], k["ioc_tile"],
                              k["p2p_round"])
    elif name in NOC_KERNELS + ("user_mailbox",):
        args = mod.bound_args(*unit_args(name, ctx, st, ln)[0])
    elif name == "iocoom_commit":
        args = mod.bound_args(sim.params.iocoom, st.ioc, ln,
                              sim.models.ioc_tile, core, sim.device_trace,
                              st.mem.req.slot_lat_ps, en)
    elif name == "mem_home_start":
        args = mod.bound_args(sim.models.mem, st.mem, en, ln.progress)
    elif name == "shl2_home_start":
        args = mod.bound_args(sim.models.mem, st.mem, core.freq_mhz, en,
                              ln.progress)
    elif name in ("mem_requester", "shl2_requester"):
        args = mod.bound_args(sim.models.mem, st.mem, ln, sim.device_trace,
                              core, en, ln.progress)
    else:
        args = mod.bound_args(sim.models.mem, st.mem, ln, sim.device_trace,
                              core, en, ln.progress, ln.mem_ok)
    return [t for t in args[0] if t is not None]


def fresh_times(name, sim, ctx, st, ln) -> dict:
    """Times of one call from this very state: every tensor the kernel
    binds is restored before each call, and the restores' own time is
    measured alone and taken off.  `ms` = device time (CUDA graphs of 100
    calls), `call_ms` = the eager call's host time, `plain_ms` = the
    plain version until the card finished it."""
    from graphite_tpu_torch import ops

    tensors = kernel_tensors(name, sim, ctx, st, ln)
    saved = [t.clone() for t in tensors]

    def restore():
        for t, v in zip(tensors, saved):
            t.copy_(v)

    if name == "lane_commit":
        a, k = unit_args(name, ctx, st, ln)

        def call():
            ops.lane_commit(*a, **k)

        def plain():
            ops.lane_commit_plain(*a, k["n_follow"], req=k["req"],
                                  ioc_tile=k["ioc_tile"])
    elif name in NOC_KERNELS + ("user_mailbox",):
        a, _ = unit_args(name, ctx, st, ln)

        def call():
            getattr(ops, name)(*a)

        def plain():
            getattr(ops, name + "_plain")(*a)
    else:
        def call():
            mem_call(name, sim, st, ln, plain=False)

        def plain():
            mem_call(name, sim, st, ln, plain=True)

    def both(f):
        def g():
            restore()
            f()
        return g

    out = {"ms": graph_ms(both(call)) - graph_ms(restore),
           "call_ms": host_ms(call, restore, 50, sync=False),
           "plain_ms": host_ms(plain, restore, 10, sync=True)}
    restore()
    return out


def host_ms(fn, restore, n: int, sync: bool) -> float:
    """Median host time of one call from the restored state: the eager
    call until it returns (`sync` False: the enqueue, the host's share)
    or until the card finished it (`sync` True)."""
    import torch

    times = []
    for _ in range(n + 2):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times = sorted(times[2:])
    return times[len(times) // 2] * 1e3


def mem_bound(name, sim, st, ln) -> tuple:
    """(bound_ms, bound_by, bytes, ops) of one call at this state: each
    input byte the call needs read once, each output written once,
    counted from this state's data (which lanes start, pop, fill or
    commit)."""
    import torch

    from graphite_tpu_torch.memory.common import next_present_slot
    from graphite_tpu_torch.memory.common import slots_present

    mp = sim.params.mem
    T = sim.params.n_tiles
    ms, en = st.mem, st.models_enabled
    n = lambda m: int(m.sum())  # noqa: E731
    if name == "mem_requester":
        present = slots_present(mp, ln.op, ln.flags, en)
        start = n(ln.active & (ms.req.phase == 0)
                  & (next_present_slot(present, ms.req.slot) < 3))
        rows = 8 * (mp.l1i.num_ways + mp.l1d.num_ways + mp.l2.num_ways)
        nbytes = T * 20 + start * (2 * rows + 110 + 60 + 13 + 8)
    elif name == "mem_home_start":
        from graphite_tpu_torch import ops

        live = ms.mail.req_type != 0
        homes = torch.unique(ms.mail.req_home[live]).numel()
        homes += n(ms.txn.saved_valid & ~ms.txn.active)
        # the FWD cells this call writes (13 B each; a broadcast sweep's
        # row writes all T), from its plain version on a copy
        st2, ln2 = st.clone(), ln.clone()
        ops.mem_home_start_plain(sim.models.mem, st2.mem,
                                 st2.models_enabled, ln2.progress)
        m2 = st2.mem.mail
        cells = n((m2.fwd_type != ms.mail.fwd_type)
                  | (m2.fwd_line != ms.mail.fwd_line)
                  | (m2.fwd_time != ms.mail.fwd_time))
        nbytes = T * 13 + T * 2 + homes * (
            mp.dir_ways * 8 + 2 * mp.sharer_words * 4 + 8 + 100) + cells * 13
    elif name == "shl2_requester":
        # the slot's own L1 row read by each lane that looks it up, and
        # written back only by a hit that touches it or promotes E -> M;
        # a request cell only for a miss
        w = {k: n(v) for k, v in shl2_requester_lanes(
            sim.models.mem, ms, ln, sim.device_trace, st.core, en).items()}
        row_i, row_d = 8 * mp.l1i.num_ways, 8 * mp.l1d.num_ways
        nbytes = (T * 20 + w["start"] * (90 + 8) + w["miss"] * 13
                  + (w["look_i"] + w["back_i"]) * row_i
                  + (w["look_d"] + w["back_d"]) * row_d)
    elif name == "shl2_home_start":
        live = ms.mail.req_type != 0
        homes = torch.unique(ms.mail.req_home[live]).numel()
        homes += n(ms.txn.saved_valid & ~ms.txn.active)
        # the FWD cells this call writes, from its plain version on a copy
        st2, ln2 = st.clone(), ln.clone()
        mem_call(name, sim, st2, ln2, plain=True)
        m2 = st2.mem.mail
        cells = n((m2.fwd_type != ms.mail.fwd_type)
                  | (m2.fwd_line != ms.mail.fwd_line)
                  | (m2.fwd_time != ms.mail.fwd_time))
        del st2, ln2
        nbytes = T * 13 + homes * (
            2 * 8 * mp.l2.num_ways + 2 * mp.sharer_words * 4 + 130
        ) + cells * 13
    elif name == "shl2_requester_fill":
        fills = n((ms.req.phase == 1) & (ms.mail.rep_type != 0))
        nbytes = T * 20 + fills * (2 * 8 * mp.l1d.num_ways + 13 + 70)
    elif name == "mem_requester_fill":
        fills = n((ms.req.phase == 1) & (ms.mail.rep_type != 0))
        rows = 8 * (mp.l2.num_ways + mp.l1d.num_ways)
        nbytes = T * 20 + fills * (2 * rows + 80)
    elif name == "iocoom_commit":
        instr = ln.op < 15
        commit = n(ln.active & instr & ln.mem_ok & sim.models.ioc_tile)
        p = sim.params.iocoom
        rings = 8 * (p.num_load_queue_entries
                     + 2 * p.num_store_queue_entries)
        nbytes = T * 30 + commit * (60 + 18 + rings + 50)
    else:
        return bound(name, sim, st, ln)
    return (nbytes / HBM_BYTES_PER_S * 1e3, "bytes", nbytes, 0)


def time_mem_kernels(sim, st, ln) -> dict:
    """At the miss-heavy state: each memory-slice kernel and the extended
    `lane_commit`, in the step's order, timed from the state it meets,
    then the unit run to advance the state."""
    from graphite_tpu_torch.engine import step
    from graphite_tpu_torch.memory import engine as me

    ctx = sim_ctx(sim)
    mctx, en = sim.models.mem, st.models_enabled
    out = {}

    def timed(name):
        out[name] = fresh_times(name, sim, ctx, st, ln)
        b_ms, b_by, nbytes, nops = mem_bound(name, sim, st, ln)
        out[name].update(bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         ops=nops)

    dummy = new_stats()
    check_kernel("lane_fetch_cost", ctx, st, ln, dummy)
    timed("mem_requester")
    mem_call("mem_requester", sim, st, ln, plain=False)
    me.home_evictions(mctx, st.mem, en, ln.progress)
    timed("mem_home_start")
    mem_call("mem_home_start", sim, st, ln, plain=False)
    me.sharer_step(mctx, st.mem, mctx.cycle_ps(st.core.freq_mhz, en), en,
                   ln.progress)
    me.home_acks_and_finish(mctx, st.mem, en, ln.progress)
    timed("mem_requester_fill")
    mem_call("mem_requester_fill", sim, st, ln, plain=False)
    units = sim.params.units
    if "net" in units:
        check_kernel("user_mailbox", ctx, st, ln, dummy)
    if "barrier" in units:
        check_kernel("barrier_sync", ctx, st, ln, dummy)
    if "models" in units:
        step.models_unit(st, ln)
    timed("iocoom_commit")
    mem_call("iocoom_commit", sim, st, ln, plain=False)
    timed("lane_commit")
    return out


def phase_memory_kernels(dev, stats) -> dict:
    """Checked iterations of the companion and of a 64-tile memstress run,
    the memory edge cases, and the kernels' times at the companion's
    first miss-heavy state."""
    import torch

    sim = companion(dev)
    found = {}

    def watch(i, st, ln):
        if "at" not in found and miss_heavy(sim, st):
            found["at"] = i
            found["state"] = (st.clone(), ln.clone())

    t0 = time.perf_counter()
    n_comp = run_checked(sim, COMPANION_CHECKED, stats, watch)
    stress = memstress(64, dev)
    n_stress = run_checked(stress, STRESS_CHECKED, stats)
    torch.cuda.synchronize()
    checked_s = time.perf_counter() - t0
    cases = mem_edge_cases(dev, stats)
    if "at" not in found:
        raise AssertionError("no checked companion iteration is miss-heavy")
    sim.state, sim._lanes = found["state"]
    timings = time_mem_kernels(sim, *found["state"])
    return {"companion_checked": n_comp, "memstress64_checked": n_stress,
            "checked_s": checked_s, "miss_heavy_at": found["at"],
            "edge_cases": cases, "timings": timings}


def phase_memory_end_to_end(dev, card: str) -> None:
    """The companion and a 16-tile memstress run on the card and on the
    CPU: every SimResults field, n_quanta, last_n_iterations and the
    line census equal."""
    cases = (("companion64", lambda d: companion(d)),
             ("memstress16", lambda d: memstress(16, d, n_accesses=200)))
    for name, build in cases:
        res = {}
        for where in (dev, "cpu"):
            sim = build(where)
            t0 = time.perf_counter()
            r = sim.run()
            lines = sorted({int(x) for x in sim.state.mem.req.line.cpu()})
            res[str(where)] = (r, sim.last_n_iterations,
                               time.perf_counter() - t0,
                               sim.line_census(lines[:64]))
        (rc, ic, wc, cc), (rp, ip, wp, cp) = res[str(dev)], res["cpu"]
        bad = [f for f in RESULT_FIELDS
               if not result_field_equal(getattr(rc, f), getattr(rp, f))]
        if ic != ip:
            bad.append("last_n_iterations")
        if cc != cp:
            bad.append("line_census")
        emit({"phase": "memory_end_to_end", "case": name, "card": card,
              "equal": not bad, "bad": bad, "iterations": ic,
              "n_quanta": rc.n_quanta, "card_s": wc, "cpu_s": wp,
              "total_instructions": rc.total_instructions,
              "l2_misses": int(rc.mem_counters["l2_misses"].sum())})
        if bad:
            raise AssertionError(f"card != cpu on {name}: {bad}")


def result_field_equal(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        if a is None or b is None or a.keys() != b.keys():
            return a is b
        return all(field_equal(a[k], b[k]) for k in a)
    return field_equal(a, b)


def phase_companion(dev) -> dict:
    """The companion at full width: warmup, then MEM_RUNS timed runs from
    one initial state, every launch count set to 0 just before each and
    read just after; every kernel of the path must launch."""
    import torch

    from graphite_tpu_torch import ops

    sim = companion(dev)
    init = sim.state._map(lambda t: t.to("cpu", copy=True))
    t0 = time.perf_counter()
    sim.warmup()
    warm_s = time.perf_counter() - t0
    walls = []
    for _ in range(MEM_RUNS):
        sim.state = init._map(lambda t: t.to(dev, copy=True))
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = sim.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        missing = [k for k in KERNEL_ORDER + MEM_KERNELS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"companion never launched {missing}")
        if counts[HOME_EXT]:
            raise AssertionError(f"the MSI full_map companion launched "
                                 f"{HOME_EXT}")
    if not bool(sim.state.done.all()):
        raise AssertionError("companion: not every tile is done")
    med = sorted(walls)[len(walls) // 2]
    iters = sim.last_n_iterations
    return {
        "tiles": 64, "points_per_tile": COMPANION_POINTS, "runs": MEM_RUNS,
        "wall_s": walls, "wall_s_median": med, "warmup_s": warm_s,
        "wall_s_spread": max(walls) - min(walls),
        "sim_instr_per_s_median": r.total_instructions / med,
        "us_per_iteration_median": med / iters * 1e6,
        "total_instructions": r.total_instructions,
        "completion_time_ps": r.completion_time_ps, "iterations": iters,
        "n_quanta": r.n_quanta,
        "l2_misses": int(r.mem_counters["l2_misses"].sum()),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "launches": counts,
    }, sim, init


def phase_north_star(dev) -> dict:
    """The 1024-tile FFT with its loads on the simple core, MSI full_map
    with the auto-sized directory, emesh_hop_counter, lax_barrier, run
    once to completion through the port's own loop."""
    import torch

    from graphite_tpu_torch import ops
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    t0 = time.perf_counter()
    batch = fft_trace(1024, points_per_tile=2048, use_memory=True)
    sim = mem_sim(1024, batch, dev, clock_scheme="lax_barrier")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(sim.state.done.all()):
        raise AssertionError("north star: not every tile is done")
    mp = sim.params.mem
    return {"tiles": 1024, "points_per_tile": 2048, "setup_s": setup_s,
            "wall_s": wall, "iterations": sim.last_n_iterations,
            "n_quanta": r.n_quanta,
            "total_instructions": r.total_instructions,
            "completion_time_ps": r.completion_time_ps,
            "sim_instr_per_s": r.total_instructions / wall,
            "l2_misses": int(r.mem_counters["l2_misses"].sum()),
            "dir_sets": mp.dir_sets, "dir_ways": mp.dir_ways,
            "sharer_words": mp.sharer_words,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "launches": ops.launch_counts()}


# --- the contention NoCs of the USER net: RADIX under hop-by-hop / ATAC ----

NOC_KERNELS = ("noc_route", "atac_route")
NOC_NETS = {"noc_route": "emesh_hop_by_hop", "atac_route": "atac"}
RADIX_TILES = 256
RADIX_KEYS = 1024
RADIX_CHECKED = 100         # its first all-to-all state is iteration 30
RADIX_RUNS = 3


def new_stats() -> dict:
    return {k: {"checks": 0, "max_abs_err": 0}
            for k in KERNEL_ORDER + MEM_KERNELS + NOC_KERNELS
            + ("mem_net_route", P2P_KERNEL, HOME_EXT) + SHL2_KERNELS}


def radix_sim(n_tiles, network, device, *, keys_per_tile=RADIX_KEYS,
              clock_scheme="lax", extra=""):
    """bench.py's hop-by-hop RADIX companion (`config_text(256, network=
    "emesh_hop_by_hop", clock_scheme="lax")`, `radix_trace(256,
    keys_per_tile=1024)`, inner_block 64), or the same under `network`."""
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.config.template import config_text
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.trace.benchmarks import radix_trace

    text = config_text(n_tiles, network=network,
                       clock_scheme=clock_scheme) + extra
    return Simulator(SimConfig(ConfigFile.from_string(text)),
                     radix_trace(n_tiles, keys_per_tile=keys_per_tile),
                     device=device, inner_block=64)


def in_all_to_all(sim, st) -> bool:
    """Whether at least half the lanes stand at a SEND record after the
    first barrier of a digit pass with more than one send a lane (the
    permutation's all-to-all)."""
    import torch

    from graphite_tpu_torch.trace.schema import Op

    tr = sim.device_trace
    idx = torch.clamp(st.core.idx, max=tr.length - 1).to(torch.int64)
    op = torch.gather(tr.op, 1, idx[:, None])[:, 0]
    prev = torch.gather(tr.op, 1, torch.clamp(idx - 1, min=0)[:, None])[:, 0]
    n = int(((op == int(Op.SEND)) & (prev == int(Op.SEND)) & ~st.done)
            .sum())
    return 2 * n >= st.done.shape[0]


def noc_rows(name, st) -> "object":
    q = st.noc_user
    return (q.queues if name == "noc_route" else q.hub_queues).data


def noc_bound(name, sim, ctx, st, ln) -> tuple:
    """(bound_ms, bound_by, bytes, ops) of one route call at this state:
    five inputs a lane read and its latency written once, and each queue
    row the call's packets touch read and written once (counted from the
    plain version's result on a copy)."""
    import torch

    from graphite_tpu_torch import ops
    from graphite_tpu_torch.trace.schema import Op

    T = sim.params.n_tiles
    st2, ln2 = st.clone(), ln.clone()
    a, _ = unit_args(name, ctx, st2, ln2)
    getattr(ops, name + "_plain")(*a)
    before, after = noc_rows(name, st), noc_rows(name, st2)
    touched = int((before != after).any(dim=1).sum())
    nbytes = T * (4 + 4 + 4 + 1 + 8 + 8) + 1 + touched * 2 * 80
    live = int((ln.active & (ln.op == int(Op.SEND))).sum())
    cells = sim.params.user_hbh.mesh_width + sim.params.user_hbh.mesh_height \
        if name == "noc_route" else 2
    nops = T * 30 + live * (cells + 2) * 40
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    del st2, ln2
    torch.cuda.synchronize()
    return ((t_bytes, "bytes", nbytes, nops) if t_bytes >= t_ops
            else (t_ops, "operations", nbytes, nops))


def phase_noc_kernels(dev, stats) -> dict:
    """Each RADIX path at 256 tiles, its first RADIX_CHECKED iterations
    checked kernel by kernel; then, at the first all-to-all state found,
    the route kernel and the routed `user_mailbox` timed from that very
    state."""
    from graphite_tpu_torch import ops
    from graphite_tpu_torch.trace.schema import Op

    out = {}
    for name in NOC_KERNELS:
        sim = radix_sim(RADIX_TILES, NOC_NETS[name], dev)
        found = {}

        def watch(i, st, ln):
            if "at" not in found and in_all_to_all(sim, st):
                found["at"] = i
                found["state"] = (st.clone(), ln.clone())

        t0 = time.perf_counter()
        n = run_checked(sim, RADIX_CHECKED, stats, watch)
        checked_s = time.perf_counter() - t0
        if "at" not in found:
            raise AssertionError(f"{name}: no checked RADIX iteration is "
                                 "in the all-to-all")
        st, ln = found["state"]
        ctx = sim_ctx(sim)
        dummy = new_stats()
        check_kernel("lane_fetch_cost", ctx, st, ln, dummy)
        sends = int((ln.active & (ln.op == int(Op.SEND))).sum())
        timings = {}
        for unit in (name, "user_mailbox"):
            timings[unit] = fresh_times(unit, sim, ctx, st, ln)
            if unit == name:
                b = noc_bound(name, sim, ctx, st, ln)
            else:
                b = bound("user_mailbox", sim, st, ln)
            timings[unit].update(bound_ms=b[0], bound_by=b[1], bytes=b[2],
                                 ops=b[3])
            # advance through the unit, as the step would
            getattr(ops, unit)(*unit_args(unit, ctx, st, ln)[0])
        out[name] = {"checked": n, "checked_s": checked_s,
                     "all_to_all_at": found["at"], "sends_at_state": sends,
                     "timings": timings}
    return out


def noc_sim(n_tiles, network, device, extra=""):
    """A sim of `network` whose lanes the edge cases set by hand (its own
    trace, a message ring, is never run)."""
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.config.template import config_text
    from graphite_tpu_torch.engine.simulator import Simulator
    from graphite_tpu_torch.trace import synthetic

    text = config_text(n_tiles, network=network, clock_scheme="lax") + extra
    return Simulator(SimConfig(ConfigFile.from_string(text)),
                     synthetic.message_ring_batch(n_tiles, 2),
                     device=device)


def noc_edge_cases(dev, stats) -> dict:
    """Hand-made lane sets over random queue states (`old`: the share of
    queues whose window start lies past every packet, so their cells
    take the M/G/1 fallback), each route kernel and the routed mailbox
    against their plain versions, with counts that show each case took
    its branch."""
    import torch

    from graphite_tpu_torch.models.network_atac import atac_use_onet
    from graphite_tpu_torch.models.queue_models import COL_ANA, COL_REQS
    from graphite_tpu_torch.trace.schema import Op

    g = torch.Generator(device="cpu").manual_seed(4321)
    out = {}

    def rint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g)

    def case(label, name, sim, dst, *, old=0.0, senders=None):
        T = sim.params.n_tiles
        st, ln = sim.state.clone(), sim._lanes.clone()
        lanes = torch.arange(T)
        send = torch.ones(T, dtype=torch.bool) if senders is None else senders
        ln.op.copy_(torch.where(send, int(Op.SEND), int(Op.BBLOCK)))
        ln.active.copy_(send)
        ln.aux0.copy_(dst)
        ln.aux1.copy_(rint(0, 300, T))
        st.core.clock_ps.copy_(rint(0, 4_000_000, T))
        q = noc_rows(name, st)
        n = q.shape[0]
        qt = rint(0, 4000, n)
        ws = torch.clamp(qt - rint(0, 150, n), min=0)
        ws = torch.where(torch.rand(n, generator=g) < old, 10**7, ws)
        n_arr = rint(1, 40, n)
        sum_st = n_arr * rint(1, 12, n)
        data = torch.stack([qt, ws, rint(1, 5000, n), sum_st,
                            sum_st * rint(1, 12, n), n_arr, n_arr, sum_st,
                            rint(0, 900, n), torch.zeros(n, dtype=torch.int64)],
                           dim=1)
        data[-1] = 0                                  # the scratch row
        q.copy_(data)
        before = q.clone()
        ctx = sim_ctx(sim)
        check_kernel(name, ctx, st, ln, stats)
        check_kernel("user_mailbox", ctx, st, ln, stats)
        after = noc_rows(name, st)
        row = {"kernel": name, "tiles": T, "senders": int(send.sum()),
               "self_sends": int((send & (dst == lanes)).sum()),
               "requests": int((after[:, COL_REQS] - before[:, COL_REQS])
                               .sum()),
               "analytical": int((after[:, COL_ANA] - before[:, COL_ANA])
                                 .sum()),
               "rows_changed": int((after != before).any(dim=1).sum()),
               "lat_sum": int(ln.route_lat_ps.sum())}
        if name == "atac_route":
            p = sim.params.user_atac
            onet = atac_use_onet(p, lanes, dst.to(torch.int64)) & send
            cross = atac_use_onet(dataclasses.replace(
                p, global_routing_strategy="cluster_based"), lanes,
                dst.to(torch.int64)) & send
            row.update(onet_lanes=int(onet.sum()),
                       cross_cluster_enet=int((cross & ~onet).sum()))
        out[label] = row

    T = RADIX_TILES
    lanes = torch.arange(T)
    for name in NOC_KERNELS:
        net = NOC_NETS[name]
        sim = noc_sim(T, net, dev)
        case(f"{name}/all_to_one", name, sim, torch.full((T,), 27))
        case(f"{name}/cross_one_row", name, sim,
             torch.where(lanes < 16, 15 - lanes, lanes), senders=lanes < 16)
        case(f"{name}/self_sends", name, sim, lanes)
        case(f"{name}/mg1_fallback", name, sim, rint(0, T, T), old=0.6)
        case(f"{name}/no_sender", name, sim, torch.full((T,), 3),
             senders=torch.zeros(T, dtype=torch.bool))
        off = noc_sim(T, net, dev, f"[network/{net}/queue_model]\n"
                      "enabled = false\n")
        case(f"{name}/contention_off", name, off, rint(0, T, T))
        case(f"{name}/tiles_1024", name, noc_sim(1024, net, dev),
             rint(0, 1024, 1024))
    dist = noc_sim(T, "atac", dev, "[network/atac]\n"
                   "global_routing_strategy = distance_based\n")
    case("atac_route/distance_based", "atac_route", dist,
         torch.where(lanes % 2 == 0, torch.clamp(lanes + 2, max=T - 1),
                     rint(0, T, T)))
    torch.cuda.empty_cache()
    bad = []
    for label, c in out.items():
        kind = label.split("/")[1]
        quiet = kind in ("no_sender", "contention_off") or (
            label == "atac_route/self_sends")
        if quiet and (c["rows_changed"] or c["requests"]):
            bad.append(f"{label}: the queues changed")
        if not quiet and c["requests"] <= 0:
            bad.append(f"{label}: no queue took a request")
        if kind == "mg1_fallback" and c["analytical"] <= 0:
            bad.append(f"{label}: no M/G/1 fallback")
        if kind == "self_sends" and c["self_sends"] != c["senders"]:
            bad.append(f"{label}: not every lane sent to itself")
        if kind == "distance_based" and c["cross_cluster_enet"] <= 0:
            bad.append(f"{label}: no short inter-cluster send on the ENet")
    if bad:
        raise AssertionError(f"NoC edge cases missed their path: {bad}")
    return out


def phase_noc_end_to_end(dev, card: str) -> None:
    """Both RADIX paths at 64 tiles on the card and on the CPU: every
    SimResults field, n_quanta, last_n_iterations and the final USER-NoC
    queues equal."""
    for name in NOC_KERNELS:
        res = {}
        for where in (dev, "cpu"):
            sim = radix_sim(64, NOC_NETS[name], where, keys_per_tile=128)
            t0 = time.perf_counter()
            r = sim.run()
            res[str(where)] = (r, sim.last_n_iterations,
                               time.perf_counter() - t0,
                               noc_rows(name, sim.state).cpu())
        (rc, ic, wc, qc), (rp, ip, wp, qp) = res[str(dev)], res["cpu"]
        bad = [f for f in RESULT_FIELDS
               if not result_field_equal(getattr(rc, f), getattr(rp, f))]
        if ic != ip:
            bad.append("last_n_iterations")
        if not bool((qc == qp).all()):
            bad.append("noc_user")
        emit({"phase": "noc_end_to_end", "case": f"radix64_{name}",
              "card": card, "equal": not bad, "bad": bad,
              "iterations": ic, "n_quanta": rc.n_quanta, "card_s": wc,
              "cpu_s": wp, "total_instructions": rc.total_instructions,
              "completion_time_ps": rc.completion_time_ps})
        if bad:
            raise AssertionError(f"card != cpu on radix64 {name}: {bad}")


def phase_radix(dev, name) -> tuple:
    """A 256-tile RADIX path at full width: warmup, then RADIX_RUNS timed
    runs from one initial state, every launch count set to 0 just before
    each and read just after; the route kernel and every kernel of the
    step must launch once an iteration."""
    import torch

    from graphite_tpu_torch import ops

    sim = radix_sim(RADIX_TILES, NOC_NETS[name], dev)
    init = sim.state._map(lambda t: t.to("cpu", copy=True))
    t0 = time.perf_counter()
    sim.warmup()
    warm_s = time.perf_counter() - t0
    walls = []
    path = KERNEL_ORDER + (name,)
    for _ in range(RADIX_RUNS):
        sim.state = init._map(lambda t: t.to(dev, copy=True))
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = sim.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        iters = sim.last_n_iterations
        off = {k: counts[k] for k in path if counts[k] != iters}
        if off:
            raise AssertionError(f"{name} RADIX: {off} launches in {iters} "
                                 "iterations: expected one an iteration")
        other = {k: n for k, n in counts.items() if n and k not in path}
        if other:
            raise AssertionError(f"{name} RADIX launched {other}")
    if not bool(sim.state.done.all()):
        raise AssertionError(f"{name} RADIX: not every tile is done")
    expect = (trace_instructions(sim.trace_batch)
              + int(r.recv_instructions.sum())
              + int(r.sync_instructions.sum()))
    if r.total_instructions != expect:
        raise AssertionError(f"{name} RADIX: {r.total_instructions} "
                             f"instructions, trace implies {expect}")
    med = sorted(walls)[len(walls) // 2]
    return {
        "network": NOC_NETS[name], "tiles": RADIX_TILES,
        "keys_per_tile": RADIX_KEYS, "runs": RADIX_RUNS, "wall_s": walls,
        "wall_s_median": med, "warmup_s": warm_s,
        "sim_instr_per_s_median": r.total_instructions / med,
        "us_per_iteration_median": med / iters * 1e6,
        "total_instructions": r.total_instructions,
        "completion_time_ps": r.completion_time_ps, "iterations": iters,
        "n_quanta": r.n_quanta, "mailbox_depth": sim.params.mailbox_depth,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "launches": counts,
    }, sim, init


# --- the contention nets as the MEMORY net: the MSI engine's routes ------

MEM_NETS = ("emesh_hop_by_hop", "atac")
NET_EXTRA = "[network]\nmemory = {net}\n"
NET_CHECKED = 129           # of each routed companion's iterations (its
#                             first miss-heavy state is iteration 128)
BIG_TILES = 1024            # the widest edge state


def net_companion(device, net, extra=""):
    """bench.py's coherence companion with `net` as the MEMORY net (the
    USER net stays the hop counter)."""
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    return mem_sim(64, fft_trace(64, points_per_tile=COMPANION_POINTS,
                                 use_memory=True), device, core="iocoom",
                   extra=NET_EXTRA.format(net=net) + extra)


def mutex_rmw_batch(n, rounds, base=0x900000, lines=2):
    """tests/test_memory_net.py's mutex-serialized shared-line
    read-modify-writes."""
    from graphite_tpu_torch.trace.schema import TraceBatch, TraceBuilder

    bs = [TraceBuilder() for _ in range(n)]
    bs[0].mutex_init(0)
    bs[0].barrier_init(9, n)
    for b in bs:
        b.barrier_wait(9)
    for r in range(n * rounds):
        b = bs[r % n]
        b.mutex_lock(0)
        for ln in range(lines):
            b.load(base + 64 * ln, 8)
            b.store(base + 64 * ln, 8)
        b.mutex_unlock(0)
    return TraceBatch.from_builders(bs)


def disjoint_stream_batch(n, accesses=60):
    """tests/test_memory_net.py's line-disjoint per-tile streams."""
    from graphite_tpu_torch.trace.schema import TraceBatch, TraceBuilder

    bs = [TraceBuilder() for _ in range(n)]
    for t, b in enumerate(bs):
        for i in range(accesses):
            addr = 0x100000 + (t * accesses + i) * 64
            (b.store if i % 3 == 0 else b.load)(addr, 8)
    return TraceBatch.from_builders(bs)


def mem_noc_rows(noc):
    return (noc.queues if hasattr(noc, "queues") else noc.hub_queues).data


def random_rows(g, n, old, device):
    """A random [n, 10] queue state (`old`: the share of rows whose window
    start lies past every packet: the M/G/1 fallback); the scratch row 0."""
    import torch

    def rint(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g)

    qt = rint(0, 4000)
    ws = torch.clamp(qt - rint(0, 150), min=0)
    ws = torch.where(torch.rand(n, generator=g) < old, 10**7, ws)
    n_arr = rint(1, 40)
    sum_st = n_arr * rint(1, 12)
    data = torch.stack([qt, ws, rint(1, 5000), sum_st, sum_st * rint(1, 12),
                        n_arr, n_arr, sum_st, rint(0, 900),
                        torch.zeros(n, dtype=torch.int64)], dim=1)
    data[-1] = 0
    return data.to(device)


def route_call(sim, noc, plain: bool, *packet):
    import importlib

    mnr = importlib.import_module("graphite_tpu_torch.ops.mem_net_route")
    fn = mnr.mem_net_route_plain if plain else mnr.mem_net_route
    return fn(sim.params.mem, noc, *packet)


def check_route(sim, noc, stats, *packet):
    """`mem_net_route` against its plain version (on a copy of the
    queues): the arrivals and every queue column equal."""
    import torch

    noc2 = noc.clone()
    a2 = route_call(sim, noc2, True, *packet)
    a1 = route_call(sim, noc, False, *packet)
    err = max(int((a1 - a2).abs().max()),
              max_abs_err(noc, noc2, "mem_net_route"))
    stats["mem_net_route"]["checks"] += 1
    stats["mem_net_route"]["max_abs_err"] = max(
        stats["mem_net_route"]["max_abs_err"], err)
    if err or not torch.equal(a1, a2):
        raise AssertionError(f"mem_net_route: kernel != plain version "
                             f"(max abs err {err})")
    return a1


def phase_memory_net_kernels(dev, stats) -> dict:
    """The companion under each contention MEMORY net: its first
    NET_CHECKED iterations checked kernel by kernel (the three memory
    kernels route inside, phases 4-5 through `mem_net_route`), then the
    four kernels timed at its first miss-heavy state."""
    import torch

    from graphite_tpu_torch.models.queue_models import COL_REQS

    out = {}
    for net in MEM_NETS:
        sim = net_companion(dev, net)
        found = {}

        def watch(i, st, ln):
            if "at" not in found and miss_heavy(sim, st):
                found["at"] = i
                found["state"] = (st.clone(), ln.clone())

        t0 = time.perf_counter()
        n = run_checked(sim, NET_CHECKED, stats, watch)
        torch.cuda.synchronize()
        checked_s = time.perf_counter() - t0
        if "at" not in found:
            raise AssertionError(f"{net}: no checked iteration is "
                                 "miss-heavy")
        reqs = int(mem_noc_rows(sim.state.mem.noc)[:, COL_REQS].sum())
        if reqs <= 0:
            raise AssertionError(f"{net}: no queue took a request")
        sim.state, sim._lanes = found["state"]
        out[net] = {"checked": n, "checked_s": checked_s,
                    "miss_heavy_at": found["at"], "noc_requests": reqs,
                    "timings": time_net_kernels(sim, *found["state"])}
        del sim
        torch.cuda.empty_cache()
    return out


def net_rows_touched(name, sim, st, ln) -> int:
    """The MEMORY-net queue rows one call of `name` changes (its plain
    version on a copy)."""
    st2, ln2 = st.clone(), ln.clone()
    mem_call(name, sim, st2, ln2, plain=True)
    before, after = mem_noc_rows(st.mem.noc), mem_noc_rows(st2.mem.noc)
    return int((before != after).any(dim=1).sum())


def time_net_kernels(sim, st, ln) -> dict:
    """At the miss-heavy state: the three memory kernels (their routed
    instantiations) and `mem_net_route` (the larger of phases 4-5's two
    packet sets), each timed from the state it meets; bounds as
    `mem_bound` plus each touched queue row read and written once."""
    from graphite_tpu_torch.memory import engine as me

    ctx = sim_ctx(sim)
    mctx, en = sim.models.mem, st.models_enabled
    out = {}

    def timed(name):
        out[name] = fresh_times(name, sim, ctx, st, ln)
        b_ms, _, nbytes, _ = mem_bound(name, sim, st, ln)
        nbytes += net_rows_touched(name, sim, st, ln) * 160
        out[name].update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                         bound_by="bytes", bytes=nbytes, ops=0)

    check_kernel("lane_fetch_cost", ctx, st, ln, new_stats())
    timed("mem_requester")
    mem_call("mem_requester", sim, st, ln, plain=False)
    me.home_evictions(mctx, st.mem, en, ln.progress)
    timed("mem_home_start")
    mem_call("mem_home_start", sim, st, ln, plain=False)
    out["mem_net_route"] = time_route(sim, st, ln)
    timed("mem_requester_fill")
    return out


def time_route(sim, st, ln) -> dict:
    """Phases 4-5 on (st, ln), their two route calls captured; the call
    with more live packets timed from the queues it met (restored before
    each call); then the same queues routing one line-carrying message
    from every tile to a random tile (`all_tiles`: the companion's
    phases 4-5 carry few packets)."""
    import importlib

    import torch

    from graphite_tpu_torch.memory import engine as me

    mnr = importlib.import_module("graphite_tpu_torch.ops.mem_net_route")
    mctx, en = sim.models.mem, st.models_enabled
    calls, orig = [], mnr.mem_net_route

    def spy(*a):
        calls.append(tuple(x.clone() if hasattr(x, "clone") else x
                           for x in a))
        return orig(*a)

    mnr.mem_net_route = spy
    try:
        me.sharer_step(mctx, st.mem, mctx.cycle_ps(st.core.freq_mhz, en),
                       en, ln.progress)
        me.home_acks_and_finish(mctx, st.mem, en, ln.progress)
    finally:
        mnr.mem_net_route = orig
    mp, noc, *packet = max(calls, key=lambda c: int(c[6].sum()))
    res = time_route_call(mnr, mp, noc, packet)
    T = packet[0].shape[0]
    g = torch.Generator(device="cpu").manual_seed(97)
    every = [x.to(sim.device) for x in (
        torch.arange(T), torch.randint(0, T, (T,), generator=g),
        torch.full((T,), mp.rep_bits), packet[3].cpu(),
        torch.ones(T, dtype=torch.bool))] + [packet[5]]
    res["all_tiles"] = time_route_call(mnr, mp, noc, every)
    return res


def time_route_call(mnr, mp, noc, packet) -> dict:
    import torch

    rows = mem_noc_rows(noc)
    saved = rows.clone()

    def restore():
        rows.copy_(saved)

    def call():
        mnr.mem_net_route(mp, noc, *packet)

    def plain():
        mnr.mem_net_route_plain(mp, noc, *packet)

    def both(f):
        def g():
            restore()
            f()
        return g

    res = {"ms": graph_ms(both(call)) - graph_ms(restore),
           "call_ms": host_ms(call, restore, 50, sync=False),
           "plain_ms": host_ms(plain, restore, 10, sync=True)}
    restore()
    plain()
    touched = int((saved != rows).any(dim=1).sum())
    restore()
    T = packet[0].shape[0]
    nbytes = T * (4 * 8 + 1 + 8) + 1 + touched * 160
    res.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               bytes=nbytes, ops=0, packets=int(packet[4].sum()),
               rows_touched=touched)
    torch.cuda.synchronize()
    return res


def fan_state(sim, homes, targets, *, owner=None, rtype=2, t0=5_000_000,
              g=None, old=0.0, enabled=True):
    """A copy of `sim`'s state in which each home of `homes` holds a line
    (its own, line % T = home) SHARED by `targets[i]` (or MODIFIED by
    `owner[i]`) and a distinct requester has an `rtype` request for it
    pending (EX = 2, SH = 1) at t0; the MEMORY net's queues random
    (`g`), or idle."""
    import torch

    from graphite_tpu_torch.memory.common import pack_bits
    from graphite_tpu_torch.ops.mem_home_start import dir_write

    st, ln = sim.state.clone(), sim._lanes.clone()
    mp, ms = sim.params.mem, st.mem
    T, dev = mp.n_tiles, sim.device
    rows = mem_noc_rows(ms.noc)
    rows.copy_(random_rows(g, rows.shape[0], old, dev) if g is not None
               else torch.zeros_like(rows))
    if not enabled:
        st.models_enabled.fill_(False)
    tiles = torch.arange(T, device=dev)
    mask = torch.zeros(T, dtype=torch.bool, device=dev)
    line = torch.zeros(T, dtype=torch.int64, device=dev)
    share = torch.zeros((T, T), dtype=torch.bool, device=dev)
    own = torch.full((T,), -1, dtype=torch.int64, device=dev)
    for i, h in enumerate(homes):
        mask[h] = True
        line[h] = h + T * (100 + i)
        if owner is None:
            share[h, torch.as_tensor(targets[i], device=dev)] = True
        else:
            share[h, owner[i]] = True
            own[h] = owner[i]
        r = (h + 1 + i) % T if owner is None else (owner[i] + 1) % T
        ms.mail.req_type[r] = rtype
        ms.mail.req_home[r] = h
        ms.mail.req_line[r] = int(line[h])
        ms.mail.req_time[r] = t0
    dir_write(ms, tiles, line % mp.dir_sets, torch.zeros_like(tiles), mask,
              tags=line, dstate=torch.full_like(line, 1 if owner is None
                                                else 2),
              owner=own, sharers=pack_bits(share, mp.sharer_words),
              nsharers=share.sum(dim=1).to(torch.int32))
    return st, ln


def mem_net_edge_cases(dev, stats) -> dict:
    """Hand-made states of the MEMORY net, each route kernel against its
    plain version, with counts that show each case took its branch:
    `mem_net_route`'s packets (all tiles to one home, self-sends, M/G/1
    fallback cells, no packet, models disabled, contention off, 1,024
    tiles) and `mem_home_start`'s fan-outs (one home to every tile, one
    target against the unicast, several homes of one ATAC cluster,
    M/G/1 fallback cells, contention off, models disabled, 1,024
    tiles)."""
    import torch

    from graphite_tpu_torch.models.queue_models import COL_ANA, COL_REQS

    g = torch.Generator(device="cpu").manual_seed(2468)
    out, bad = {}, []

    def delta(before, after):
        return {"requests": int((after - before)[:, COL_REQS].sum()),
                "analytical": int((after - before)[:, COL_ANA].sum()),
                "rows_changed": int((after != before).any(dim=1).sum())}

    def packets(sim, dst, senders=None, enabled=True):
        mp = sim.params.mem
        T = mp.n_tiles
        mask = (torch.ones(T, dtype=torch.bool) if senders is None
                else senders)
        bits = torch.where(torch.rand(T, generator=g) < 0.5, mp.rep_bits,
                           mp.req_bits)
        t0 = torch.randint(0, 4_000_000, (T,), generator=g)
        return tuple(x.to(dev) for x in (
            torch.arange(T), torch.as_tensor(dst), bits, t0, mask,
            torch.tensor(enabled)))

    def route(label, sim, dst, *, senders=None, old=0.0, enabled=True):
        noc = sim.state.mem.noc.clone()
        rows = mem_noc_rows(noc)
        rows.copy_(random_rows(g, rows.shape[0], old, dev))
        before = rows.clone()
        pk = packets(sim, dst, senders, enabled)
        arr = check_route(sim, noc, stats, *pk)
        out[label] = {"tiles": sim.params.n_tiles,
                      "live": int(pk[4].sum()) if enabled else 0,
                      **delta(before, mem_noc_rows(noc)),
                      "arrival_eq_t0": bool(torch.equal(arr, pk[3]))}

    def fan(label, sim, homes, targets, **kw):
        kw.setdefault("g", g)
        st, ln = fan_state(sim, homes, targets, **kw)
        before = mem_noc_rows(st.mem.noc).clone()
        check_mem_kernel("mem_home_start", sim, st, ln, stats)
        fwd = st.mem.mail.fwd_type != 0
        out[label] = {"tiles": sim.params.n_tiles, "homes": len(homes),
                      "copies": int(fwd.sum()),
                      "max_copies_a_home": int(fwd.sum(dim=0).max()),
                      **delta(before, mem_noc_rows(st.mem.noc))}
        return st

    for net in MEM_NETS:
        sim = net_companion(dev, net)
        T = sim.params.n_tiles
        lanes = torch.arange(T)
        route(f"{net}/route_all_to_one", sim, torch.full((T,), 27))
        route(f"{net}/route_self_sends", sim, lanes)
        route(f"{net}/route_mg1_fallback", sim,
              torch.randint(0, T, (T,), generator=g), old=0.6)
        route(f"{net}/route_no_packet", sim, torch.full((T,), 3),
              senders=torch.zeros(T, dtype=torch.bool))
        route(f"{net}/route_models_disabled", sim,
              torch.randint(0, T, (T,), generator=g), enabled=False)
        fan(f"{net}/fan_one_home_to_every_tile", sim, [0], [lanes])
        # one target on idle queues: the copy arrives as the unicast does
        st = fan(f"{net}/fan_single_target", sim, [5], None, owner=[9],
                 rtype=1, t0=7_000_000, g=None)
        noc0 = sim.state.mem.noc.clone()
        mem_noc_rows(noc0).zero_()
        sel = torch.zeros(T, dtype=torch.bool)
        sel[5] = True
        t0 = st.mem.txn.time_ps.clone()
        uni = check_route(sim, noc0, stats, *(x.to(dev) for x in (
            torch.arange(T), torch.full((T,), 9), torch.full(
                (T,), sim.params.mem.req_bits), t0.cpu(), sel,
            torch.tensor(True))))
        out[f"{net}/fan_single_target"].update(
            fanout_ps=int(st.mem.mail.fwd_time[9, 5]), unicast_ps=int(uni[5]))
        homes = [0, 1, 8, 9]          # ATAC cluster 0 of the 8 x 8 mesh
        far = [[20, 30, 45, 63, 2], [36, 50, 7], [60, 61, 10, 33],
               [40, 41, 42, 43, 9]]
        fan(f"{net}/fan_homes_of_one_cluster", sim, homes, far)
        fan(f"{net}/fan_mg1_fallback", sim, list(range(0, 64, 4)),
            [[(h + k * 5) % T for k in range(1, 6)]
             for h in range(0, 64, 4)], old=0.7)
        fan(f"{net}/fan_models_disabled", sim, [0], [lanes], enabled=False)
        off = net_companion(dev, net, f"[network/{net}/queue_model]\n"
                            "enabled = false\n")
        route(f"{net}/route_contention_off", off,
              torch.randint(0, T, (T,), generator=g))
        fan(f"{net}/fan_contention_off", off, [0], [lanes])
        big = memstress(BIG_TILES, dev, n_accesses=6,
                        extra=NET_EXTRA.format(net=net))
        route(f"{net}/route_tiles_1024", big,
              torch.randint(0, BIG_TILES, (BIG_TILES,), generator=g))
        fan(f"{net}/fan_one_home_to_every_tile_1024", big, [7],
            [torch.arange(BIG_TILES)])
        # every kernel on a whole iteration of 1,024 tiles
        out[f"{net}/iterations_1024"] = {"iterations": run_checked(
            big, 40, stats)}
        del sim, off, big
        torch.cuda.empty_cache()
    for label, c in out.items():
        kind = label.split("/")[1]
        quiet = kind in ("route_no_packet", "route_models_disabled",
                         "fan_models_disabled", "route_contention_off",
                         "fan_contention_off") or (
            kind == "route_self_sends" and label.startswith("atac"))
        if "requests" in c and quiet and (c["rows_changed"]
                                          or c["requests"]):
            bad.append(f"{label}: the queues changed")
        if "requests" in c and not quiet and c["requests"] <= 0:
            bad.append(f"{label}: no queue took a request")
        if "mg1" in kind and c["analytical"] <= 0:
            bad.append(f"{label}: no M/G/1 fallback")
        if kind.startswith("fan_one_home") and (
                c["max_copies_a_home"] != c["tiles"]):
            bad.append(f"{label}: {c['max_copies_a_home']} copies, not "
                       "one a tile")
        if kind == "fan_single_target" and (
                c["copies"] != 1 or c["fanout_ps"] != c["unicast_ps"]):
            bad.append(f"{label}: the copy != the unicast")
        if kind == "fan_homes_of_one_cluster" and c["copies"] != 17:
            bad.append(f"{label}: {c['copies']} copies")
        if kind == "route_models_disabled" and not c["arrival_eq_t0"]:
            bad.append(f"{label}: arrivals != send times")
    hub = out["atac/fan_homes_of_one_cluster"]
    if hub["requests"] != 4 or hub["rows_changed"] != 1:
        bad.append("atac/fan_homes_of_one_cluster: not one send hub "
                   "charged by four homes")
    if bad:
        raise AssertionError(f"MEMORY-net edge cases missed their path: "
                             f"{bad}")
    return out


NET_E2E_CASES = ("mutex_rmw16", "disjoint16", "companion64")


def net_e2e_run(net: str, name: str, where) -> tuple:
    """One case of `phase_memory_net_end_to_end` on `where`, run to
    completion: (SimResults, iterations, wall s, the line census of its
    first 64 requested lines, the MEMORY net's queue rows as numpy)."""
    extra = NET_EXTRA.format(net=net)
    if name == "mutex_rmw16":
        sim = mem_sim(16, mutex_rmw_batch(16, 3), where, extra=extra)
    elif name == "disjoint16":
        sim = mem_sim(16, disjoint_stream_batch(16), where, extra=extra)
    else:
        sim = net_companion(where, net)
    t0 = time.perf_counter()
    r = sim.run()
    lines = sorted({int(x) for x in sim.state.mem.req.line.cpu()})
    return (r, sim.last_n_iterations, time.perf_counter() - t0,
            sim.line_census(lines[:64]),
            mem_noc_rows(sim.state.mem.noc).cpu().numpy())


def one_thread() -> None:
    import torch

    torch.set_num_threads(1)


def start_net_e2e_cpu(pool) -> dict:
    """The CPU sides of `phase_memory_net_end_to_end`, submitted to `pool`
    (one worker process on one thread) so that they run while the card
    checks the MEMORY-net kernels."""
    return {(net, name): pool.submit(net_e2e_run, net, name, "cpu")
            for net in MEM_NETS for name in NET_E2E_CASES}


def phase_memory_net_end_to_end(dev, card: str, cpu_runs: dict) -> None:
    """Card against CPU under each contention MEMORY net: the 16-tile
    mutex-serialized and line-disjoint traces of tests/test_memory_net.py
    and the 64-tile companion to completion; every SimResults field,
    n_quanta, last_n_iterations, the line census and `MemState.noc`
    equal.  `cpu_runs` holds the futures of the CPU sides
    (`start_net_e2e_cpu`)."""
    import numpy as np

    for net in MEM_NETS:
        for name in NET_E2E_CASES:
            rc, ic, wc, cc, qc = net_e2e_run(net, name, dev)
            rp, ip, wp, cp, qp = cpu_runs[net, name].result()
            bad = [f for f in RESULT_FIELDS
                   if not result_field_equal(getattr(rc, f), getattr(rp, f))]
            if ic != ip:
                bad.append("last_n_iterations")
            if cc != cp:
                bad.append("line_census")
            if not np.array_equal(qc, qp):
                bad.append("mem.noc")
            emit({"phase": "memory_net_end_to_end", "net": net,
                  "case": name, "card": card, "equal": not bad, "bad": bad,
                  "iterations": ic, "n_quanta": rc.n_quanta, "card_s": wc,
                  "cpu_s": wp, "total_instructions": rc.total_instructions,
                  "completion_time_ps": rc.completion_time_ps,
                  "noc_requests": int(qc[:, 6].sum())})
            if bad:
                raise AssertionError(f"card != cpu on {name} ({net}): {bad}")


def phase_net_companion(dev, net) -> tuple:
    """The companion under `net` at full width: warmup, then MEM_RUNS
    timed runs from one initial state; each run launches each of its
    eight kernels once an iteration, replays the two phase graphs once an
    iteration (the host's only other launches) and `mem_net_route` twice
    an iteration inside them, plus twice for each state captured (the
    count the graphs keep; the profile of the run checks the device's).
    Returns the numbers, the simulator and the initial state."""
    import torch

    from graphite_tpu_torch import ops

    sim = net_companion(dev, net)
    graphs = sim.models.mem.phase_graphs
    init = sim.state._map(lambda t: t.to("cpu", copy=True))
    t0 = time.perf_counter()
    sim.warmup()
    warm_s = time.perf_counter() - t0
    walls = []
    path = KERNEL_ORDER + MEM_KERNELS
    for _ in range(MEM_RUNS):
        sim.state = init._map(lambda t: t.to(dev, copy=True))
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        replays, captures = graphs.replays, graphs.captures
        t0 = time.perf_counter()
        r = sim.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        iters = sim.last_n_iterations
        replays = graphs.replays - replays
        captures = graphs.captures - captures
        off = {k: counts[k] for k in path if counts[k] != iters}
        if replays != 2 * iters:
            off["graph replays"] = replays
        if counts["mem_net_route"] != 2 * (iters + captures):
            off["mem_net_route"] = counts["mem_net_route"]
        other = {k: n for k, n in counts.items()
                 if n and k not in path + ("mem_net_route",)}
        if off or other:
            raise AssertionError(f"{net} companion: launches {off} "
                                 f"{other} in {iters} iterations")
    if not bool(sim.state.done.all()):
        raise AssertionError(f"{net} companion: not every tile is done")
    med = sorted(walls)[len(walls) // 2]
    return {
        "memory_net": net, "tiles": 64, "points_per_tile": COMPANION_POINTS,
        "runs": MEM_RUNS, "wall_s": walls, "wall_s_median": med,
        "wall_s_spread": max(walls) - min(walls), "warmup_s": warm_s,
        "sim_instr_per_s_median": r.total_instructions / med,
        "us_per_iteration_median": med / iters * 1e6,
        "total_instructions": r.total_instructions,
        "completion_time_ps": r.completion_time_ps, "iterations": iters,
        "n_quanta": r.n_quanta,
        "l2_misses": int(r.mem_counters["l2_misses"].sum()),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "host_launches_per_iteration": {
            "kernels": len(path), "graphs": replays // iters},
        "graph_captures": captures, "launches": counts,
    }, sim, init


def phase_hbh_north_star(dev) -> dict:
    """The north star's rung on the contention NoCs: the 1024-tile FFT
    with its loads on MSI full_map (auto directory, lax_barrier) with
    emesh_hop_by_hop as the USER and the MEMORY net (bench.py's 1024-tile
    coherence ladder's first rung), once, to completion."""
    import torch

    from graphite_tpu_torch import ops
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    t0 = time.perf_counter()
    batch = fft_trace(1024, points_per_tile=2048, use_memory=True)
    sim = mem_sim(1024, batch, dev, network="emesh_hop_by_hop",
                  clock_scheme="lax_barrier")
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(sim.state.done.all()):
        raise AssertionError("hop-by-hop north star: not every tile is "
                             "done")
    counts = ops.launch_counts()
    missing = [k for k in MEM_KERNELS[:3] + ("noc_route", "mem_net_route")
               if counts[k] <= 0]
    if missing:
        raise AssertionError(f"hop-by-hop north star never launched "
                             f"{missing}")
    return {"tiles": 1024, "points_per_tile": 2048, "network":
            "emesh_hop_by_hop (USER and MEMORY)", "setup_s": setup_s,
            "wall_s": wall, "iterations": sim.last_n_iterations,
            "n_quanta": r.n_quanta,
            "total_instructions": r.total_instructions,
            "completion_time_ps": r.completion_time_ps,
            "sim_instr_per_s": r.total_instructions / wall,
            "us_per_iteration": wall / sim.last_n_iterations * 1e6,
            "l2_misses": int(r.mem_counters["l2_misses"].sum()),
            "mem_noc_requests": int(mem_noc_rows(sim.state.mem.noc)[:, 6]
                                    .sum()),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "launches": counts}


# --- the outputs slice: lax_p2p, barrier_host, the generators, outputs ----

P2P_SLACK = "[clock_skew_management/lax_p2p]\nslack = {ns}\n"
# the 1024-tile FFT under lax_p2p at a 10 ns slack: its first 1,024
# iterations are the all-to-all's sends, in which every tile does the same
# work and no lane can be held; from the receives on ~250 lanes an
# iteration are.  Checked: P2P_CHECKED iterations from P2P_FIRST.
P2P_FIRST = 1024
P2P_CHECKED = 150
# the kernels timed at a send state and at a receive state with holds
P2P_TIMING_AT = {"send_phase": 200, "receive_phase": P2P_FIRST + 100}
P2P_RUNS = 3                # and as many lax runs, in turns
P2P_EDGE_CONFIG = """
[general]
total_cores = {n}
mode = lite
max_frequency = 1.0
[network]
user = magic
memory = magic
[core/static_instruction_costs]
ialu = 1
imul = 100
[clock_skew_management]
scheme = lax_p2p
[clock_skew_management/lax_p2p]
slack = {slack_ns}
"""


def text_sim(text, batch, device, **kw):
    from graphite_tpu_torch.config import ConfigFile, SimConfig
    from graphite_tpu_torch.engine.simulator import Simulator

    return Simulator(SimConfig(ConfigFile.from_string(text)), batch,
                     device=device, **kw)


def held_lanes(ln) -> int:
    """Lanes the lax_p2p hold kept back this iteration (qend never binds
    under lax_p2p: a lane not done and not active is held)."""
    return int((~ln.done & ~ln.active).sum())


def phase_p2p_kernel(dev, batch, stats) -> dict:
    """The p2p `lane_fetch_cost` and `lane_commit` (and the mailbox and
    barrier kernels) against their plain versions on each of P2P_CHECKED
    iterations of the 1024-tile FFT under lax_p2p at a 10 ns slack from
    iteration P2P_FIRST (the kernels alone run the iterations before),
    counting the held lanes; the four kernels timed at the iterations of
    P2P_TIMING_AT."""
    import torch

    from graphite_tpu_torch.engine.step import subquantum_iteration

    sim = make_sim(1024, batch, dev, scheme="lax_p2p",
                   extra=P2P_SLACK.format(ns=10), inner_block=64)
    ctx = Ctx(sim.params, sim.device_trace, sim_qend(sim), sim._cost_table)
    st, ln = sim.state, sim._lanes
    at = {i: state for state, i in P2P_TIMING_AT.items()}
    timings = {}
    for i in range(P2P_FIRST):
        if i in at:
            timings[at[i]] = time_kernels(sim, ctx, st.clone(), ln.clone())
        subquantum_iteration(sim.params, ctx.trace, st, ctx.qend, ln,
                             ctx.cost_table)
    held = []
    t0 = time.perf_counter()
    for i in range(P2P_FIRST, P2P_FIRST + P2P_CHECKED):
        if i in at:
            timings[at[i]] = time_kernels(sim, ctx, st.clone(), ln.clone())
        checked_iteration(ctx, st, ln, stats)
        held.append(held_lanes(ln))
    torch.cuda.synchronize()
    if sum(h > 0 for h in held) < P2P_CHECKED // 2:
        raise AssertionError(f"p2p: lanes held in only "
                             f"{sum(h > 0 for h in held)} iterations")
    if int(st.p2p_round) != P2P_FIRST + P2P_CHECKED:
        raise AssertionError(f"p2p: round {int(st.p2p_round)} after "
                             f"{P2P_FIRST + P2P_CHECKED} iterations")
    return {"tiles": 1024, "slack_ns": 10, "first_checked": P2P_FIRST,
            "iterations_checked": P2P_CHECKED,
            "checked_s": time.perf_counter() - t0,
            "held_total": sum(held), "held_max": max(held),
            "held_at_receive_state":
                held[P2P_TIMING_AT["receive_phase"] - P2P_FIRST],
            "iterations_with_held": sum(h > 0 for h in held),
            "timings": timings}


def ialu_rows(n_tiles, length):
    """Each tile: `length` IALU records, then THREAD_EXIT."""
    from graphite_tpu_torch.trace.schema import Op, TraceBatch, TraceBuilder

    bs = [TraceBuilder() for _ in range(n_tiles)]
    for b in bs:
        for _ in range(length):
            b.instr(Op.IALU)
    return TraceBatch.from_builders(bs)


def p2p_step(dev, stats, n, clocks, idx, done, rnd, enabled=True,
             length=6) -> dict:
    """One checked iteration of an n-tile IALU trace under lax_p2p (10 ns
    slack) from a hand-set state; returns the pre-step state on the host,
    the partners and the active mask."""
    import torch

    from graphite_tpu_torch.ops.lane_fetch_cost import p2p_partner

    sim = text_sim(P2P_EDGE_CONFIG.format(n=n, slack_ns=10),
                   ialu_rows(n, length), dev)
    ctx = Ctx(sim.params, sim.device_trace, sim_qend(sim), sim._cost_table)
    st, ln = sim.state, sim._lanes
    st.core.clock_ps.copy_(torch.as_tensor(clocks, dtype=torch.int64))
    st.core.idx.copy_(torch.as_tensor(idx, dtype=torch.int32))
    st.done.copy_(torch.as_tensor(done, dtype=torch.bool))
    st.p2p_round.fill_(rnd)
    st.models_enabled.fill_(enabled)
    pre = {"clock": st.core.clock_ps.cpu().numpy().copy(),
           "idx": st.core.idx.cpu().numpy().copy(),
           "done": st.done.cpu().numpy().copy(),
           "partner": p2p_partner(st.p2p_round, n).cpu().numpy()}
    checked_iteration(ctx, st, ln, stats)
    pre["active"] = ln.active.cpu().numpy()
    pre["held"] = held_lanes(ln)
    pre["costed"] = int((ln.cost_ps != 0).sum())
    pre["round_after"] = int(st.p2p_round)
    pre["slack"] = sim.params.p2p_slack_ps
    return pre


def p2p_random(g, n, length=6):
    """Clocks within a few slacks, a third of the lanes at THREAD_EXIT, a
    fifth done."""
    import numpy as np

    idx = np.where(g.random(n) < 0.3, length, g.integers(0, length, n))
    return g.integers(0, 50_000, n), idx, g.random(n) < 0.2


def p2p_edge_cases(dev, stats) -> list:
    """Hand-set states of the p2p hold, each checked kernel against plain
    and printed with the count that shows its branch."""
    import numpy as np

    g = np.random.default_rng(7)
    out = []
    # partners that fetch THREAD_EXIT on this very iteration: a third of
    # the lanes far ahead, a third behind at their exit record (free by
    # this iteration's latch), a third behind and running (held)
    n = 64
    third = np.arange(n) % 3
    clocks = np.where(third == 0, 10**6, 0)
    idx = np.where(third == 1, 6, 0)
    r = p2p_step(dev, stats, n, clocks, idx, np.zeros(n, bool), 12345)
    p = r["partner"]
    fresh = (r["idx"][p] == 6) & ~r["done"][p]
    ahead = r["clock"] > r["clock"][p] + r["slack"]
    free = int((ahead & fresh & r["active"]).sum())
    out.append({"case": "partner_fetches_thread_exit", "free_by_latch": free,
                "held": r["held"]})
    if free == 0 or r["held"] == 0:
        raise AssertionError(f"p2p edge: partner exit branch {out[-1]}")
    # lane counts around the CTA of 64 lanes
    for n in (1, 2, 37, 1000):
        clocks, idx, done = p2p_random(g, n)
        r = p2p_step(dev, stats, n, clocks, idx, done,
                     int(g.integers(-2**31, 2**31)))
        out.append({"case": f"tiles_{n}", "held": r["held"]})
        if n > 2 and r["held"] == 0:
            raise AssertionError(f"p2p edge: nothing held at {n} tiles")
    # the round counter at the int32 edge and its wrap
    clocks, idx, done = p2p_random(g, 64)
    r = p2p_step(dev, stats, 64, clocks, idx, done, 2**31 - 1)
    out.append({"case": "round_int32_max", "held": r["held"],
                "round_after": r["round_after"]})
    if r["round_after"] != -2**31:
        raise AssertionError(f"p2p edge: round wrapped to {r['round_after']}")
    # every lane but the laggard ahead: only the lanes whose partner is
    # the laggard hold
    n = 64
    clocks = np.full(n, 10**6)
    clocks[5] = 0
    r = p2p_step(dev, stats, n, clocks, np.zeros(n, int), np.zeros(n, bool),
                 99)
    want = int((r["partner"] == 5).sum()) - int(r["partner"][5] == 5)
    out.append({"case": "all_but_laggard_ahead", "held": r["held"],
                "partners_of_laggard": want})
    if not r["active"][5] or r["held"] != want or want == 0:
        raise AssertionError(f"p2p edge: laggard case {out[-1]}")
    # models disabled: no cost, the hold as with the models enabled
    clocks, idx, done = p2p_random(g, 64)
    on = p2p_step(dev, stats, 64, clocks, idx, done, 7)
    r = p2p_step(dev, stats, 64, clocks, idx, done, 7, enabled=False)
    out.append({"case": "models_disabled", "held": r["held"],
                "costed": r["costed"], "costed_enabled": on["costed"]})
    if (r["held"] == 0 or r["held"] != on["held"] or r["costed"]
            or not on["costed"]):
        raise AssertionError(f"p2p edge: models disabled case {out[-1]}")
    return out


SKEW_TEXT = P2P_EDGE_CONFIG.format(n=2, slack_ns=100)


def skew_batch():
    """tests/test_p2p.py's skew trace: tile 0 runs 1-cycle records, tile 1
    100-cycle records."""
    from graphite_tpu_torch.trace.schema import Op, TraceBatch, TraceBuilder

    b0, b1 = TraceBuilder(), TraceBuilder()
    for _ in range(400):
        b0.instr(Op.IALU)
        b1.instr(Op.IMUL)
    return TraceBatch.from_builders([b0, b1])


def p2p_e2e_cases() -> list:
    """(name, builder(device) -> Simulator) of the card-vs-CPU runs."""
    from graphite_tpu_torch.trace import synthetic
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    slack = P2P_SLACK.format(ns=10)
    stress = synthetic.memory_stress_trace(
        16, n_accesses=40, working_set_bytes=1 << 13, write_fraction=0.4,
        shared_fraction=0.5, seed=7)
    fft64 = fft_trace(64)
    return [
        ("fft64_p2p", lambda d: make_sim(64, fft64, d, scheme="lax_p2p",
                                         extra=slack, inner_block=32)),
        ("skew2_p2p", lambda d: text_sim(SKEW_TEXT, skew_batch(), d)),
        ("memstress16_p2p", lambda d: mem_sim(16, stress, d,
                                              clock_scheme="lax_p2p",
                                              extra=slack)),
        ("fft64_barrier_host_batch3", lambda d: make_sim(
            64, fft_trace(64, points_per_tile=64), d, scheme="lax_barrier",
            inner_block=32, barrier_host=True, barrier_batch=3)),
    ]


def card_vs_cpu(name, build, dev) -> dict:
    """One case on the card and on the CPU: every SimResults field,
    n_quanta and last_n_iterations equal, or raise."""
    res = {}
    for where in (dev, "cpu"):
        sim = build(where)
        t0 = time.perf_counter()
        r = sim.run()
        res[str(where)] = (r, sim.last_n_iterations,
                           time.perf_counter() - t0)
    (rc, ic, wc), (rp, ip, wp) = res[str(dev)], res["cpu"]
    bad = [f for f in RESULT_FIELDS
           if not result_field_equal(getattr(rc, f), getattr(rp, f))]
    if ic != ip:
        bad.append("last_n_iterations")
    if bad:
        raise AssertionError(f"card != cpu on {name}: {bad}")
    return {"case": name, "tiles": rc.n_tiles, "equal": True,
            "n_quanta": rc.n_quanta, "iterations": ic, "card_s": wc,
            "cpu_s": wp, "total_instructions": rc.total_instructions,
            "completion_time_ps": rc.completion_time_ps}


def run_counted(sim, dev) -> tuple:
    """One run to completion from the launch counts at 0; returns (the
    results, wall s, the counts, peak device memory)."""
    import torch

    from graphite_tpu_torch import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(sim.state.done.all()):
        raise AssertionError("a run ended with tiles not done")
    return r, wall, ops.launch_counts(), torch.cuda.max_memory_allocated(dev)


def phase_p2p_full_width(dev, batch, lax_full, lax_sim, lax_init) -> dict:
    """The headline config under lax_p2p at the default slack: warmup, then
    P2P_RUNS timed runs, in turns with as many runs of the lax headline
    (L P P L L P), each from its initial state with the launch counts at
    0 just before it: the p2p `lane_fetch_cost` and the other three
    kernels once an iteration (4 launches), the lax instantiation never.
    The scheme schedules, it does not time: the results equal the lax
    headline's."""
    sim = make_sim(1024, batch, dev, scheme="lax_p2p", inner_block=64)
    init = sim.state._map(lambda t: t.to("cpu", copy=True))
    t0 = time.perf_counter()
    sim.warmup()
    warm_s = time.perf_counter() - t0
    walls = {"lax": [], "lax_p2p": []}
    path = (P2P_KERNEL,) + KERNEL_ORDER[1:]
    for turn in "LPPLLP":
        run_sim, i0, key = ((sim, init, "lax_p2p") if turn == "P"
                            else (lax_sim, lax_init, "lax"))
        run_sim.state = i0._map(lambda t: t.to(dev, copy=True))
        r, wall, counts, peak = run_counted(run_sim, dev)
        walls[key].append(wall)
        if turn == "L":
            continue
        iters = sim.last_n_iterations
        off = {k: counts[k] for k in path if counts[k] != iters}
        if off or counts["lane_fetch_cost"]:
            raise AssertionError(f"p2p headline: {counts} launches in "
                                 f"{iters} iterations")
        if (r.completion_time_ps != lax_full["completion_time_ps"]
                or r.total_instructions != lax_full["total_instructions"]):
            raise AssertionError("p2p headline: results differ from lax")
        p2p_r, p2p_counts, p2p_peak = r, counts, peak
    med = statistics.median(walls["lax_p2p"])
    lax_med = statistics.median(walls["lax"])
    held = held_headline(dev, batch, lax_full, path)
    return {
        "tiles": 1024, "points_per_tile": 2048, "slack_ns": 1000,
        "runs": P2P_RUNS, "order": "LPPLLP", "wall_s": walls["lax_p2p"],
        "wall_s_median": med, "lax_wall_s": walls["lax"],
        "lax_wall_s_median": lax_med, "p2p_over_lax": med / lax_med,
        "warmup_s": warm_s, "iterations": iters, "n_quanta": p2p_r.n_quanta,
        "us_per_iteration_median": med / iters * 1e6,
        "lax_us_per_iteration_median": (lax_med / lax_sim.last_n_iterations
                                        * 1e6),
        "sim_instr_per_s_median": p2p_r.total_instructions / med,
        "total_instructions": p2p_r.total_instructions,
        "completion_time_ps": p2p_r.completion_time_ps,
        "launches_per_iteration": sum(p2p_counts[k] for k in path) / iters,
        "max_memory_allocated": p2p_peak, "launches": p2p_counts,
        "slack_10ns": held}


def held_headline(dev, batch, lax_full, path) -> dict:
    """The headline under lax_p2p at a 10 ns slack, where lanes are held
    from the first receive on: warmup, then one timed run to completion
    with 4 launches an iteration and the lax headline's results."""
    sim = make_sim(1024, batch, dev, scheme="lax_p2p",
                   extra=P2P_SLACK.format(ns=10), inner_block=64)
    init = sim.state._map(lambda t: t.to("cpu", copy=True))
    sim.warmup()
    sim.state = init._map(lambda t: t.to(dev, copy=True))
    r, wall, counts, peak = run_counted(sim, dev)
    iters = sim.last_n_iterations
    off = {k: counts[k] for k in path if counts[k] != iters}
    if off or counts["lane_fetch_cost"]:
        raise AssertionError(f"p2p headline at 10 ns: {counts} launches in "
                             f"{iters} iterations")
    if (r.completion_time_ps != lax_full["completion_time_ps"]
            or r.total_instructions != lax_full["total_instructions"]):
        raise AssertionError("p2p headline at 10 ns: results differ from lax")
    return {"wall_s": wall, "iterations": iters, "n_quanta": r.n_quanta,
            "us_per_iteration": wall / iters * 1e6,
            "sim_instr_per_s": r.total_instructions / wall,
            "launches_per_iteration": sum(counts[k] for k in path) / iters,
            "max_memory_allocated": peak}


def workload_row(name, sim, dev, path) -> dict:
    """One run to completion of a BASELINE workload on the card: wall,
    iterations, instr/s, peak memory; every kernel of `path` launched."""
    r, wall, counts, peak = run_counted(sim, dev)
    missing = [k for k in path if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{name} never launched {missing}")
    row = {"workload": name, "tiles": r.n_tiles, "wall_s": wall,
           "iterations": sim.last_n_iterations, "n_quanta": r.n_quanta,
           "total_instructions": r.total_instructions,
           "completion_time_ps": r.completion_time_ps,
           "sim_instr_per_s": r.total_instructions / wall,
           "max_memory_allocated": peak, "launches": counts}
    if r.mem_counters is not None:
        row["l2_misses"] = int(r.mem_counters["l2_misses"].sum())
        row["func_errors"] = r.func_errors
    return row


def phase_workloads(dev) -> list:
    """blackscholes (1024 tiles, the headline config) and canneal (1024
    tiles, MSI full_map, lax_barrier), each once to completion; ping-pong
    on config_text(16) and every other BENCHMARKS entry at 64 tiles, card
    against CPU."""
    from graphite_tpu_torch.config.template import config_text
    from graphite_tpu_torch.trace import synthetic
    from graphite_tpu_torch.trace.benchmarks import BENCHMARKS

    rows = []
    bs = BENCHMARKS["blackscholes"](1024)
    sim = make_sim(1024, bs, dev, inner_block=64)
    row = workload_row("blackscholes", sim, dev,
                       ("lane_fetch_cost", "barrier_sync", "lane_commit"))
    expect = trace_instructions(bs) + int(sim.state.core.sync_instructions
                                          .sum())
    if row["total_instructions"] != expect:
        raise AssertionError(f"blackscholes: {row['total_instructions']} "
                             f"instructions, trace implies {expect}")
    rows.append(row)
    del sim
    t0 = time.perf_counter()
    sim = mem_sim(1024, BENCHMARKS["canneal"](1024), dev,
                  clock_scheme="lax_barrier")
    setup = time.perf_counter() - t0
    row = workload_row("canneal", sim, dev,
                       ("lane_fetch_cost", "barrier_sync", "lane_commit")
                       + MEM_KERNELS[:3])
    if row["func_errors"]:
        raise AssertionError("canneal: functional errors")
    rows.append({**row, "setup_s": setup})
    del sim
    rows.append({"workload": "ping_pong", **card_vs_cpu(
        "ping_pong16", lambda d: text_sim(
            config_text(16), synthetic.ping_pong_trace(16), d), dev)})
    for name, gen in BENCHMARKS.items():
        if name in ("blackscholes", "canneal"):
            continue
        batch = gen(64)
        rows.append({"workload": name, **card_vs_cpu(
            f"{name}64", lambda d: make_sim(64, batch, d, inner_block=32),
            dev)})
    return rows


STATS_EXTRA = """
[statistics_trace]
enabled = true
statistics = "cache_line_replication, network_utilization, cache_line_utilization"
sampling_interval = 2000
[progress_trace]
enabled = true
[l2_cache/T1]
track_cache_line_utilization = true
"""


def outputs_sim(device, extra=""):
    """The outputs phase's run: 64 tiles of the coherence stress trace on
    MSI full_map, lax_barrier (quanta to checkpoint and sample at)."""
    from graphite_tpu_torch.trace import synthetic

    return mem_sim(64, synthetic.memory_stress_trace(
        64, n_accesses=40, working_set_bytes=1 << 13, write_fraction=0.4,
        shared_fraction=0.5, seed=3), device, clock_scheme="lax_barrier",
        extra=extra)


def files_of(d) -> dict:
    return {fn: open(os.path.join(d, fn), "rb").read()
            for fn in sorted(os.listdir(d))}


def phase_outputs(dev) -> dict:
    """sim.out and carbon_sim.cfg of a card run byte-equal to the CPU
    run's; a checkpoint saved mid-run on the card, loaded into a new
    Simulator on the card and run on, equal to the uninterrupted run; the
    chunked StatisticsManager's files of a card run byte-equal to the CPU
    run's."""
    import tempfile

    from graphite_tpu_torch.system import (
        StatisticsManager, load_checkpoint, save_checkpoint,
    )

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        results = {}
        for where in (dev, "cpu"):
            sim = outputs_sim(where)
            results[str(where)] = sim.run()
            sim.write_output(results[str(where)],
                             os.path.join(tmp, f"out_{where}"))
        card = files_of(os.path.join(tmp, f"out_{dev}"))
        if card != files_of(os.path.join(tmp, "out_cpu")):
            raise AssertionError("sim.out / carbon_sim.cfg: card != cpu")
        out["sim_out_bytes"] = len(card["sim.out"])
        ref = results[str(dev)]
        sim = outputs_sim(dev)
        done, nq = sim.run_chunk(2)
        if done:
            raise AssertionError("checkpoint: the run ended in 2 quanta")
        ck = os.path.join(tmp, "ckpt.npz")
        save_checkpoint(sim, ck, n_quanta=nq)
        resumed = outputs_sim(dev)
        if load_checkpoint(resumed, ck) != nq:
            raise AssertionError("checkpoint: bad quantum counter")
        r = resumed.run()
        bad = [f for f in RESULT_FIELDS if f != "n_quanta"
               and not result_field_equal(getattr(r, f), getattr(ref, f))]
        if bad:
            raise AssertionError(f"checkpoint resume != uninterrupted: {bad}")
        out["checkpoint"] = {"saved_at_quanta": nq,
                             "bytes": os.path.getsize(ck),
                             "completion_time_ps": r.completion_time_ps}
        for where in (dev, "cpu"):
            StatisticsManager(outputs_sim(where, STATS_EXTRA),
                              os.path.join(tmp, f"stats_{where}")).run()
        card = files_of(os.path.join(tmp, f"stats_{dev}"))
        if card != files_of(os.path.join(tmp, "stats_cpu")):
            raise AssertionError("statistics traces: card != cpu")
        out["statistics"] = {fn: len(b.splitlines()) for fn, b in
                             card.items()}
    return out


# --- MOSI and the directory schemes on the private-L2 engine -------------

MSI = "pr_l1_pr_l2_dram_directory_msi"
MOSI = "pr_l1_pr_l2_dram_directory_mosi"
MOSI_SCHEMES = ("limited_no_broadcast", "ackwise", "limited_broadcast",
                "limitless")
MOSI_K = 4                  # max_hw_sharers of the canneal runs
MOSI_CHECKED = 30           # checked iterations of each 64-tile canneal
# a 700 MHz DIRECTORY domain: the limitless trap's ceil-division shows
ODD_DIR = ("[dvfs]\nsynchronization_delay = 2\ndomains = \"<1.0, CORE, "
           "L1_ICACHE, L1_DCACHE, NETWORK_USER><0.7, L2_CACHE, DIRECTORY, "
           "NETWORK_MEMORY>\"\n[limitless]\nsoftware_trap_penalty = 201\n")
MOSI_E2E_CASES = tuple(f"canneal64/{s}" for s in MOSI_SCHEMES) + tuple(
    f"memstress16_ackwise2/{net}" for net in MEM_NETS)


def scheme_extra(scheme, k=MOSI_K, protocol=MOSI) -> str:
    return (f"[caching_protocol]\ntype = {protocol}\n[dram_directory]\n"
            f"directory_type = {scheme}\nmax_hw_sharers = {k}\n")


def canneal64(device, scheme):
    """The canneal trace at 64 tiles over a 256-line footprint (about 64
    loads a line, so sharers overflow k = 4) under MOSI and `scheme`."""
    from graphite_tpu_torch.trace.benchmarks import canneal_trace

    return mem_sim(64, canneal_trace(64, footprint_lines=256), device,
                   clock_scheme="lax_barrier", extra=scheme_extra(scheme))


def mosi_e2e_sim(name, where):
    kind, arg = name.split("/")
    if kind == "canneal64":
        return canneal64(where, arg)
    return memstress(16, where, extra=scheme_extra("ackwise", 2)
                     + NET_EXTRA.format(net=arg))


def mosi_e2e_run(name, where) -> tuple:
    """One case of `phase_mosi_end_to_end` on `where`, run to completion:
    (SimResults, iterations, wall s, the line census of its first 64
    requested lines, the MEMORY net's queue rows or None)."""
    sim = mosi_e2e_sim(name, where)
    t0 = time.perf_counter()
    r = sim.run()
    lines = sorted({int(x) for x in sim.state.mem.req.line.cpu()})
    noc = sim.state.mem.noc
    return (r, sim.last_n_iterations, time.perf_counter() - t0,
            sim.line_census(lines[:64]),
            None if noc is None else mem_noc_rows(noc).cpu().numpy())


def start_mosi_cpu(pool) -> dict:
    """The CPU sides of `phase_mosi_end_to_end`, queued on `pool` behind
    the MEMORY-net cases (they run while the card works on later
    phases)."""
    return {name: pool.submit(mosi_e2e_run, name, "cpu")
            for name in MOSI_E2E_CASES}


def phase_mosi_end_to_end(dev, card: str, stats, cpu_runs: dict) -> None:
    """Card against CPU: the 64-tile canneal under MOSI with each of the
    four limited schemes (k = 4), its first MOSI_CHECKED iterations
    checked kernel by kernel first, and the 16-tile stress trace under
    MOSI + ackwise (k = 2) over each contention MEMORY net; every
    SimResults field, n_quanta, last_n_iterations, the line census and
    `MemState.noc` equal."""
    import numpy as np

    for name in MOSI_E2E_CASES:
        checked = 0
        if name.startswith("canneal64"):
            checked = run_checked(mosi_e2e_sim(name, dev), MOSI_CHECKED,
                                  stats)
        rc, ic, wc, cc, qc = mosi_e2e_run(name, dev)
        rp, ip, wp, cp, qp = cpu_runs[name].result()
        bad = [f for f in RESULT_FIELDS
               if not result_field_equal(getattr(rc, f), getattr(rp, f))]
        if ic != ip:
            bad.append("last_n_iterations")
        if cc != cp:
            bad.append("line_census")
        if (qc is None) != (qp is None) or (
                qc is not None and not np.array_equal(qc, qp)):
            bad.append("mem.noc")
        mc = rc.mem_counters
        emit({"phase": "mosi_end_to_end", "case": name, "card": card,
              "equal": not bad, "bad": bad, "checked_iterations": checked,
              "iterations": ic, "n_quanta": rc.n_quanta, "card_s": wc,
              "cpu_s": wp, "total_instructions": rc.total_instructions,
              "completion_time_ps": rc.completion_time_ps,
              "func_errors": rc.func_errors,
              **{k: int(mc[k].sum()) for k in (
                  "dir_broadcasts", "invalidations", "dram_writes",
                  "dir_accesses")}})
        if bad:
            raise AssertionError(f"card != cpu on {name}: {bad}")
        if rc.func_errors:
            raise AssertionError(f"{name}: functional errors")


# name -> (protocol, scheme, k, entry state, owner, sharers, request type)
HOME_CASES = {
    "sh_fetch_owner": (MOSI, "full_map", 2, 3, 2, (2, 9), 1),
    "sh_fetch_lowest_sharer": (MOSI, "full_map", 2, 1, -1, (3, 9, 12), 1),
    "flush_pick_shared": (MOSI, "full_map", 2, 1, -1, (3, 9, 12), 2),
    "flush_pick_owned": (MOSI, "full_map", 2, 3, 9, (3, 9), 2),
    "sh_over_msi": (MSI, "limited_no_broadcast", 2, 1, -1, (3, 9), 1),
    "sh_over_mosi_shared": (MOSI, "limited_no_broadcast", 2, 1, -1, (3, 9),
                            1),
    "sh_over_mosi_owned": (MOSI, "limited_no_broadcast", 2, 3, 3, (3, 9), 1),
    "victim_is_owner": (MOSI, "limited_no_broadcast", 1, 3, 3, (3,), 1),
    "sh_over_m": (MOSI, "limited_no_broadcast", 1, 2, 3, (3,), 1),
    "over_bc_ackwise": (MOSI, "ackwise", 2, 1, -1, (3, 9, 12), 2),
    "over_bc_limited_broadcast": (MSI, "limited_broadcast", 2, 1, -1,
                                  (3, 9, 12), 2),
    "limitless_trap": (MSI, "limitless", 2, 1, -1, (3, 9, 12), 1),
}
EDGE_HOME, EDGE_REQ = 5, 7


def home_state(sim, case):
    """A copy of `sim`'s state in which home EDGE_HOME holds its line in
    the case's directory entry and EDGE_REQ's request for it is pending
    (every home of a contention net's case does the same with its own
    line, so that the routed form carries T rows)."""
    import torch

    from graphite_tpu_torch.memory.common import pack_bits
    from graphite_tpu_torch.ops.mem_home_start import dir_write

    _, _, _, dstate, owner, sharers, rtype = case
    st, ln = sim.state.clone(), sim._lanes.clone()
    mp, ms, dev = sim.params.mem, st.mem, sim.device
    T = mp.n_tiles
    tiles = torch.arange(T, device=dev)
    homes = [EDGE_HOME] if ms.noc is None else list(range(T))
    line = tiles + T * 40
    mask = torch.zeros(T, dtype=torch.bool, device=dev)
    share = torch.zeros((T, T), dtype=torch.bool, device=dev)
    own = torch.full((T,), -1, dtype=torch.int64, device=dev)
    for h in homes:
        r = (h + EDGE_REQ - EDGE_HOME) % T
        mask[h] = True
        share[h, [(s + h - EDGE_HOME) % T for s in sharers]] = True
        own[h] = -1 if owner < 0 else (owner + h - EDGE_HOME) % T
        ms.mail.req_type[r] = rtype
        ms.mail.req_home[r] = h
        ms.mail.req_line[r] = int(line[h])
        ms.mail.req_time[r] = 3_000_000 + 1000 * h
    dir_write(ms, tiles, line % mp.dir_sets, torch.zeros_like(tiles), mask,
              tags=line, dstate=torch.full_like(line, dstate), owner=own,
              sharers=pack_bits(share, mp.sharer_words),
              nsharers=share.sum(dim=1).to(torch.int32))
    return st, ln


def msi_full_map(sim):
    """The MSI full_map context of `sim`'s memory parameters (the
    reference every edge state's branch differs from)."""
    from graphite_tpu_torch.memory.context import MemCtx

    return MemCtx(dataclasses.replace(sim.params.mem, protocol=MSI,
                                      dir_type="full_map"), sim.device)


def branch_shown(a, b) -> list:
    """The memory-state leaves in which two results differ."""
    import torch

    lb = dict(leaves(b))
    return [k for k, x in leaves(a) if not torch.equal(x, lb[k])]


def mosi_edge_cases(dev, stats) -> dict:
    """Hand-set states where each branch of the slice fires, each kernel
    against its plain version on them, and the leaves in which the result
    differs from the MSI full_map result of the same state (each case
    must differ): `mem_home_start` on every HOME_CASES state (under the
    hop counter; the broadcast sweep also under each contention net, one
    sweep a home), `mem_requester` on lanes writing lines their L2 holds
    OWNED (the upgrade's FLUSH), and `mem_requester_fill` on replies
    whose L2 set is full of OWNED lines (the victim's FLUSH)."""
    import torch

    from graphite_tpu_torch import ops
    from graphite_tpu_torch.memory import cache_array as ca
    from graphite_tpu_torch.trace.schema import TraceBatch, TraceBuilder

    out, bad = {}, []
    T = 16

    def own_lines_batch():
        bs = [TraceBuilder() for _ in range(T)]
        for t, b in enumerate(bs):
            b.store(0x100000 + t * 64 * 64, 8)
            b.load(0x200000 + t * 64 * 64, 8)
        return TraceBatch.from_builders(bs)

    for name, case in HOME_CASES.items():
        protocol, scheme, k = case[:3]
        nets = (None,) + (MEM_NETS if name == "over_bc_ackwise" else ())
        for net in nets:
            extra = scheme_extra(scheme, k, protocol) + ODD_DIR + (
                "" if net is None else NET_EXTRA.format(net=net))
            sim = memstress(T, dev, n_accesses=4, extra=extra)
            st, ln = home_state(sim, case)
            ref = st.clone()
            ops.mem_home_start_plain(msi_full_map(sim), ref.mem,
                                     ref.models_enabled,
                                     ln.clone().progress)
            check_mem_kernel("mem_home_start", sim, st, ln, stats)
            label = name if net is None else f"{name}/{net}"
            fwd = st.mem.mail.fwd_type[:, EDGE_HOME]
            out[label] = {
                "copies": int((fwd != 0).sum()),
                "messages": sorted({int(m) for m in fwd if m}),
                "dir_broadcasts": int(st.mem.counters.dir_broadcasts.sum()),
                "differs_from_msi_full_map": branch_shown(st.mem, ref.mem)}
            if not out[label]["differs_from_msi_full_map"]:
                bad.append(label)
            if name.startswith("over_bc") and out[label]["copies"] != T:
                bad.append(f"{label}: {out[label]['copies']} copies")

    # the OWNED upgrade: every lane writes a line its L2 holds OWNED
    for state in (ca.OWNED, ca.SHARED):
        sim = mem_sim(T, own_lines_batch(), dev, extra=scheme_extra(
            "full_map"))
        ctx = sim_ctx(sim)
        st, ln = sim.state.clone(), sim._lanes.clone()
        check_kernel("lane_fetch_cost", ctx, st, ln, stats)
        mp = sim.params.mem
        for t in range(T):
            line = (0x100000 + t * 64 * 64) >> mp.line_bits
            st.mem.l2.meta[t, line % mp.l2.num_sets, 0] = ca.pack(
                line, state, 0)
        check_mem_kernel("mem_requester", sim, st, ln, stats)
        ev = st.mem.mail.evict_type
        out[f"owned_upgrade/{'OWNED' if state == ca.OWNED else 'SHARED'}"] = {
            "flush_rep": int((ev == 7).sum()), "inv_rep": int((ev == 6)
                                                              .sum())}
    if out["owned_upgrade/OWNED"]["flush_rep"] != T or out[
            "owned_upgrade/SHARED"]["inv_rep"] != T:
        bad.append("owned_upgrade")

    # the OWNED victim: every lane's reply lands in an L2 set full of
    # OWNED lines
    for state in (ca.OWNED, ca.SHARED):
        sim = mem_sim(T, own_lines_batch(), dev, extra=scheme_extra(
            "full_map"))
        ctx = sim_ctx(sim)
        st, ln = sim.state.clone(), sim._lanes.clone()
        check_kernel("lane_fetch_cost", ctx, st, ln, stats)
        mp, ms = sim.params.mem, st.mem
        S, W = mp.l2.num_sets, mp.l2.num_ways
        for t in range(T):
            line = (0x200000 + t * 64 * 64) >> mp.line_bits
            for w in range(W):
                ms.l2.meta[t, line % S, w] = ca.pack(
                    line + (w + 1) * S, state, w)
            ms.req.phase[t] = 1
            ms.req.slot[t] = 1
            ms.req.line[t] = line
            ms.req.component[t] = 2
            ms.mail.rep_type[t] = 9
            ms.mail.rep_time[t] = 4_000_000 + t
        check_mem_kernel("mem_requester_fill", sim, st, ln, stats)
        ev = st.mem.mail.evict_type
        out[f"owned_victim/{'OWNED' if state == ca.OWNED else 'SHARED'}"] = {
            "flush_rep": int((ev == 7).sum()), "inv_rep": int((ev == 6)
                                                              .sum())}
    if out["owned_victim/OWNED"]["flush_rep"] != T or out[
            "owned_victim/SHARED"]["inv_rep"] != T:
        bad.append("owned_victim")
    del sim
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"MOSI edge states missed their branch: {bad}")
    return out


def mosi_kernel_times(dev) -> dict:
    """The three memory kernels timed at the companion's first miss-heavy
    state under MOSI + ackwise (k = 4), reached by the step unchecked
    (the MSI times come from the same call's `memory_kernel` lines)."""
    from graphite_tpu_torch.engine.step import subquantum_iteration
    from graphite_tpu_torch.trace.benchmarks import fft_trace

    sim = mem_sim(64, fft_trace(64, points_per_tile=COMPANION_POINTS,
                                use_memory=True), dev, core="iocoom",
                  extra=scheme_extra("ackwise"))
    st, ln, qend = sim.state, sim._lanes, sim_qend(sim)
    for at in range(COMPANION_CHECKED):
        if miss_heavy(sim, st):
            break
        subquantum_iteration(sim.params, sim.device_trace, st, qend, ln,
                             sim._cost_table, sim.models)
    else:
        raise AssertionError("no MOSI companion iteration is miss-heavy")
    t = time_mem_kernels(sim, st, ln)
    return {"miss_heavy_at": at,
            "timings": {k: t[k] for k in MEM_KERNELS[:3]}}


def overflowed_entries(sim, k) -> int:
    """Directory entries holding more than k sharers at the end of a run
    (the entries a limitless directory serves in software)."""
    from graphite_tpu_torch.memory.common import dir_nsh, dir_tag

    e = sim.state.mem.directory.entry
    return int(((dir_tag(e) >= 0) & (dir_nsh(e) > k)).sum())


MOSI_WINDOW = 40            # checked iterations of the 1,024-tile canneal
#                             at its densest broadcasts
MOSI_BURST = 64             # broadcasts of the quantum they are taken from


def count_sum(sim, name) -> int:
    return int(getattr(sim.state.mem.counters, name).sum())


def quantum_end(sim):
    """The boundary `run_simulation` gives the quantum that a
    `run_chunk(1)` call starts from this state (its previous boundary 0)."""
    import torch

    from graphite_tpu_torch.engine.loop import BIG

    q = sim.quantum_ps
    if q is None:
        return sim_qend(sim)
    st = sim.state
    pending = torch.where(~st.done, st.core.clock_ps, BIG).min()
    boundary = (torch.div(pending, q, rounding_mode="floor") + 1) * q
    return torch.clamp(boundary, min=q)


def event_ms(fn, restore, n: int) -> float:
    """Median device time of one call from the restored state, between
    two CUDA events (the restore, enqueued first, outlasts the call's
    enqueue, so the call waits on the card, not on the host)."""
    import torch

    times = []
    for _ in range(n):
        restore()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def home_start_at(sim, ctx, st, ln) -> dict:
    """`mem_home_start`'s times and bound in the iteration that starts
    at (st, ln), at the state it meets there (after phases 1-2); the
    state is left as the kernel's call leaves it.  Timed with events: a
    graph of 100 calls would restore the 1,024-tile directory (GBs) 100
    times around a call of µs."""
    from graphite_tpu_torch.memory import engine as me

    check_kernel("lane_fetch_cost", ctx, st, ln, new_stats())
    mem_call("mem_requester", sim, st, ln, plain=False)
    me.home_evictions(sim.models.mem, st.mem, st.models_enabled,
                      ln.progress)
    tensors = kernel_tensors("mem_home_start", sim, ctx, st, ln)
    saved = [t.clone() for t in tensors]

    def restore():
        for t, v in zip(tensors, saved):
            t.copy_(v)

    def call():
        mem_call("mem_home_start", sim, st, ln, plain=False)

    def plain():
        mem_call("mem_home_start", sim, st, ln, plain=True)

    out = {"us": event_ms(call, restore, 21) * 1e3,
           "plain_us": host_ms(plain, restore, 5, sync=True) * 1e3}
    restore()
    b_ms, b_by, nbytes, _ = mem_bound("mem_home_start", sim, st, ln)
    before = count_sum(sim, "dir_broadcasts")
    call()
    del saved
    return {**out, "bound_us": b_ms * 1e3, "bound_by": b_by,
            "bytes": nbytes,
            "broadcasts": count_sum(sim, "dir_broadcasts") - before}


def phase_mosi_window(dev, batch, stats) -> dict:
    """The slice's main path checked at its own shapes: canneal at 1,024
    tiles on MOSI + ackwise (k = 4), run through `run_chunk(1)` to the
    first quantum that broadcasts MOSI_BURST times or more; that quantum
    replayed from its start, iteration by iteration at its boundary, to
    count each iteration's broadcasts; then the MOSI_WINDOW iterations
    that hold the most of them, every kernel checked against its plain
    version (max abs err 0, at least one broadcast inside); and
    `mem_home_start[ext]` timed at the iteration with the most broadcast
    rows and at one with none."""
    import torch

    from graphite_tpu_torch.engine.step import subquantum_iteration

    sim = mem_sim(1024, batch, dev, clock_scheme="lax_barrier",
                  extra=scheme_extra("ackwise"))
    t0 = time.perf_counter()
    quanta = 0
    while True:
        start = sim.state.clone()
        before = count_sum(sim, "dir_broadcasts")
        done, n = sim.run_chunk(1)
        quanta += n
        in_quantum = count_sum(sim, "dir_broadcasts") - before
        if in_quantum >= MOSI_BURST:
            break
        if done or not n:
            raise AssertionError(f"canneal/mosi/ackwise: no quantum "
                                 f"broadcasts {MOSI_BURST} times")
    iters = sim.last_n_iterations
    find_s = time.perf_counter() - t0

    def replay(n):
        """The quantum's state after its first n iterations, and the
        iteration context at its boundary."""
        sim.state = start.clone()
        qend = quantum_end(sim)
        for _ in range(n):
            subquantum_iteration(sim.params, sim.device_trace, sim.state,
                                 qend, sim._lanes, sim._cost_table,
                                 sim.models)
        return Ctx(sim.params, sim.device_trace, qend, sim._cost_table,
                   sim.models)

    # each iteration's broadcasts
    ctx = replay(0)
    per_it = []
    for _ in range(iters):
        b0 = count_sum(sim, "dir_broadcasts")
        subquantum_iteration(sim.params, sim.device_trace, sim.state,
                             ctx.qend, sim._lanes, sim._cost_table,
                             sim.models)
        per_it.append(count_sum(sim, "dir_broadcasts") - b0)
    width = MOSI_WINDOW
    sums = [sum(per_it[i:i + width]) for i in range(max(1, iters - width
                                                        + 1))]
    at = max(range(len(sums)), key=sums.__getitem__)
    busiest = max(range(iters), key=per_it.__getitem__)
    quiet = per_it.index(0) if 0 in per_it else None
    timed = {}
    for name, it in (("most_broadcasts", busiest), ("none", quiet)):
        if it is not None:
            ctx = replay(it)
            timed[name] = {"iteration": it,
                           **home_start_at(sim, ctx, sim.state, sim._lanes)}
    ctx = replay(at)
    st, ln = sim.state, sim._lanes
    before = count_sum(sim, "dir_broadcasts")
    t0 = time.perf_counter()
    checked = 0
    for _ in range(width):
        checked_iteration(ctx, st, ln, stats, sim=sim)
        checked += 1
        if bool(st.done.all()):
            break
    torch.cuda.synchronize()
    out = {"workload": "canneal/mosi/ackwise",
           "tiles": sim.params.n_tiles,
           "sharer_words": sim.params.mem.sharer_words,
           "quanta_run": quanta, "find_s": find_s,
           "quantum_iterations": iters,
           "quantum_broadcasts": in_quantum,
           "replayed_broadcasts": sum(per_it),
           "window_from_iteration": at, "checked_iterations": checked,
           "checked_s": time.perf_counter() - t0,
           "broadcasts_in_window": count_sum(sim, "dir_broadcasts")
           - before,
           "home_start": timed}
    del sim, start, st, ln
    torch.cuda.empty_cache()
    if out["broadcasts_in_window"] <= 0 or (
            timed["most_broadcasts"]["broadcasts"] <= 0):
        raise AssertionError("canneal/mosi/ackwise: no broadcast in the "
                             "checked window")
    return out


def phase_mosi_full_width(dev, batch, build_s) -> list:
    """canneal at 1,024 tiles (`batch`: 4,096-line footprint, 64 swaps a
    tile, built in `build_s`) on `config_text(1024, shared_mem=True,
    clock_scheme="lax_barrier")` under MOSI with an ackwise directory of
    k = 4, the slice's main path, once to completion with the launch
    counts from 0 (func_errors 0, at least one broadcast, phase 3 only
    through `mem_home_start[ext]`); then the same under
    limited_no_broadcast and limitless."""
    import torch

    rows = []
    for scheme in ("ackwise", "limited_no_broadcast", "limitless"):
        sim = mem_sim(1024, batch, dev, clock_scheme="lax_barrier",
                      extra=scheme_extra(scheme))
        row = workload_row(f"canneal/mosi/{scheme}", sim, dev,
                           ("lane_fetch_cost", "barrier_sync", "lane_commit",
                            "mem_requester", HOME_EXT, "mem_requester_fill"))
        if row["launches"]["mem_home_start"]:
            raise AssertionError(f"{row['workload']} launched the MSI "
                                 "full_map form of mem_home_start")
        cnt = sim.state.mem.counters
        row.update(scheme=scheme, max_hw_sharers=MOSI_K,
                   trace_build_s=build_s,
                   overflowed_entries=overflowed_entries(sim, MOSI_K),
                   **{k: int(getattr(cnt, k).sum()) for k in (
                       "dir_broadcasts", "invalidations", "dram_writes",
                       "dram_reads", "dir_accesses", "evictions")})
        if row["func_errors"]:
            raise AssertionError(f"{row['workload']}: functional errors")
        if scheme == "ackwise" and row["dir_broadcasts"] <= 0:
            raise AssertionError("canneal/mosi/ackwise: no broadcast")
        rows.append(row)
        del sim
        torch.cuda.empty_cache()
    return rows


# --- the shared-L2 engine (pr_l1_sh_l2_msi / _mesi) ------------------------

SHL2_MSI = "pr_l1_sh_l2_msi"
SHL2_MESI = "pr_l1_sh_l2_mesi"
SHL2_K = 4                  # max_hw_sharers of the canneal runs
SHL2_CHECKED = 20           # checked iterations of each 64-tile canneal
SHL2_WINDOW = 40            # checked iterations of the 1,024-tile canneal
SHL2_SCAN = 6               # quanta scanned for the one with the most fills
SHL2_E2E_CASES = tuple(
    f"canneal64/{p}/{s}" for p in ("msi", "mesi")
    for s in ("full_map", "ackwise", "limited_no_broadcast", "limitless"))
SHL2_NET_CASES = tuple(f"memstress16_ackwise2/{net}" for net in MEM_NETS)
SHL2_EDGE_T = 40            # two sharer words, the second one padded


def shl2_e2e_sim(name, where):
    kind, *rest = name.split("/")
    if kind == "canneal64":
        from graphite_tpu_torch.trace.benchmarks import canneal_trace

        proto, scheme = rest
        return mem_sim(64, canneal_trace(64, footprint_lines=256), where,
                       clock_scheme="lax_barrier",
                       extra=scheme_extra(scheme, SHL2_K,
                                          f"pr_l1_sh_l2_{proto}"))
    return memstress(16, where, extra=scheme_extra("ackwise", 2, SHL2_MSI)
                     + NET_EXTRA.format(net=rest[0]))


def shl2_e2e_run(name, where) -> tuple:
    """One case of `phase_shl2_end_to_end` on `where`, to completion:
    (SimResults, iterations, wall s, the line census of its first 64
    requested lines, the MEMORY net's queue rows or None)."""
    sim = shl2_e2e_sim(name, where)
    t0 = time.perf_counter()
    r = sim.run()
    lines = sorted({int(x) for x in sim.state.mem.req.line.cpu()})
    noc = sim.state.mem.noc
    return (r, sim.last_n_iterations, time.perf_counter() - t0,
            sim.line_census(lines[:64]),
            None if noc is None else mem_noc_rows(noc).cpu().numpy())


def start_shl2_cpu(pool, cases) -> dict:
    """The CPU sides of `phase_shl2_end_to_end`, queued on `pool`."""
    return {name: pool.submit(shl2_e2e_run, name, "cpu") for name in cases}


def phase_shl2_end_to_end(dev, card: str, stats, cpu_runs: dict) -> None:
    """Card against CPU: the 64-tile canneal under shared-L2 MSI and MESI
    with full_map and each limited scheme but limited_broadcast (k = 4),
    and the 16-tile stress trace under shared-L2 MSI + ackwise (k = 2)
    over each contention MEMORY net, each case's first SHL2_CHECKED
    iterations checked kernel by kernel first; every SimResults field
    (mem_counters
    and func_errors with them), n_quanta, last_n_iterations, the line
    census and `ShL2State.noc` equal."""
    import numpy as np

    for name in cpu_runs:
        checked = run_checked(shl2_e2e_sim(name, dev), SHL2_CHECKED, stats)
        rc, ic, wc, cc, qc = shl2_e2e_run(name, dev)
        rp, ip, wp, cp, qp = cpu_runs[name].result()
        bad = [f for f in RESULT_FIELDS
               if not result_field_equal(getattr(rc, f), getattr(rp, f))]
        if ic != ip:
            bad.append("last_n_iterations")
        if cc != cp:
            bad.append("line_census")
        if (qc is None) != (qp is None) or (
                qc is not None and not np.array_equal(qc, qp)):
            bad.append("mem.noc")
        mc = rc.mem_counters
        emit({"phase": "shl2_end_to_end", "case": name, "card": card,
              "equal": not bad, "bad": bad, "checked_iterations": checked,
              "iterations": ic, "n_quanta": rc.n_quanta, "card_s": wc,
              "cpu_s": wp, "total_instructions": rc.total_instructions,
              "completion_time_ps": rc.completion_time_ps,
              "func_errors": rc.func_errors,
              **{k: int(mc[k].sum()) for k in (
                  "l2_misses", "dir_broadcasts", "invalidations",
                  "dram_writes", "dir_accesses")}})
        if bad:
            raise AssertionError(f"card != cpu on {name}: {bad}")
        if rc.func_errors:
            raise AssertionError(f"{name}: functional errors")


def shl2_sim(n_tiles, device, protocol=SHL2_MESI, scheme="full_map", k=2):
    """A shared-L2 run of a tiny stress trace over the magic net (its
    lanes idle: the edge states are set by hand)."""
    from graphite_tpu_torch.trace import synthetic

    return mem_sim(n_tiles, synthetic.memory_stress_trace(
        n_tiles, n_accesses=2, seed=1), device, network="magic",
        extra=scheme_extra(scheme, k, protocol)
        + "[limitless]\nsoftware_trap_penalty = 201\n")


def put_slice_line(sim, ms, home, line, way, l2_state, dstate=0, owner=-1,
                   sharers=()):
    """Slice line `line` at `way` on `home`, with its directory entry."""
    import torch

    from graphite_tpu_torch.memory import cache_array as ca

    mp = sim.params.mem
    S2, W2, SW = mp.l2.num_sets, mp.l2.num_ways, mp.sharer_words
    s = line % S2
    lru = int(ms.l2.meta[home, s, way]) & 0xFF
    ms.l2.meta[home, s, way] = ca.pack(line, l2_state, lru)
    ms.dir.word[home, s, way] = (dstate | ((owner + 1) << 3)
                                 | (len(sharers) << 16))
    row = [0] * SW
    for t in sharers:
        row[t // 32] |= 1 << (t % 32)
    sh = ms.dir.sharers.view(mp.n_tiles, S2, W2, SW)
    sh[home, s, way] = torch.tensor(
        [w - (1 << 32) if w >= 1 << 31 else w for w in row],
        dtype=torch.int32)


def shl2_request(ms, r, rtype, line, home, t=3_000_000):
    ms.mail.req_type[r] = rtype
    ms.mail.req_home[r] = home
    ms.mail.req_line[r] = line
    ms.mail.req_time[r] = t


def shl2_edge_cases(dev, stats) -> dict:
    """Hand-set states, one a branch, each shared-L2 kernel against its
    plain version (`torch.equal` on every leaf of the state and lanes),
    each with the count that shows its branch: a NULLIFY of a slice
    victim with L1 sharers, then the saved request resuming; a second
    request to a line still DATA_INVALID; MESI's EXCLUSIVE fill, the
    silent E->M promote and a second reader's WB downgrade; an ackwise
    broadcast row at 1,024 tiles and an upgrade's sweep at 40;
    limited_no_broadcast's displacement; the limitless trap; a fill
    waiting on a busy eviction cell; and at T = 40 (two sharer words,
    the second padded) sharers past tile 31 in every home-start case."""
    import torch

    from graphite_tpu_torch.memory import cache_array as ca

    out, bad = {}, []
    T, H, R = SHL2_EDGE_T, 5, 7
    stride = lambda sim: sim.params.n_tiles * sim.params.mem.l2.num_sets  # noqa: E731

    def home_case(label, sim, setup, show, timed=False):
        st, ln = sim.state.clone(), sim._lanes.clone()
        setup(sim, st.mem)
        t = (kernel_at("shl2_home_start", sim, st, ln) if timed else {})
        check_mem_kernel("shl2_home_start", sim, st, ln, stats)
        fwd = st.mem.mail.fwd_type[:, H]
        out[label] = {"copies": int((fwd != 0).sum()),
                      "messages": sorted({int(m) for m in fwd if m}),
                      "active": bool(st.mem.txn.active[H]),
                      **{k: t[k] for k in ("us", "bound_us") if k in t},
                      **show(sim, st.mem)}
        return st, ln

    def full_set(dstate, sharers, l2_state=ca.SHARED):
        def setup(sim, ms):
            for w in range(sim.params.mem.l2.num_ways):
                last = w == sim.params.mem.l2.num_ways - 1
                put_slice_line(sim, ms, H, H + (w + 1) * stride(sim), w,
                               l2_state if last else ca.SHARED,
                               dstate if last else 0, -1,
                               sharers if last else ())
            shl2_request(ms, R, 1, H + 20 * stride(sim), H)
        return setup

    # the NULLIFY of a victim with sharers (tile 35 in the padded word)
    sim = shl2_sim(T, dev, SHL2_MSI)
    st, ln = home_case("nullify_victim_with_sharers", sim,
                       full_set(1, (3, R, 35)), lambda sim, ms: {
                           "mtype": int(ms.txn.mtype[H]),
                           "saved": bool(ms.txn.saved_valid[H])})
    if out["nullify_victim_with_sharers"]["mtype"] != 11 or out[
            "nullify_victim_with_sharers"]["copies"] != 3:
        bad.append("nullify_victim_with_sharers")
    # ... the NULLIFY over, the saved request resumes and installs
    ms = st.mem
    ms.txn.active[H] = False
    ms.txn.pending[H] = 0
    ms.mail.fwd_type.zero_()
    W2 = sim.params.mem.l2.num_ways
    put_slice_line(sim, ms, H, H + W2 * stride(sim), W2 - 1, ca.INVALID)
    check_mem_kernel("shl2_home_start", sim, st, ln, stats)
    out["saved_request_resumes"] = {
        "saved": bool(ms.txn.saved_valid[H]),
        "l2_misses": int(ms.counters.l2_misses[H])}
    if out["saved_request_resumes"] != {"saved": False, "l2_misses": 1}:
        bad.append("saved_request_resumes")
    # a second request to a line still DATA_INVALID
    sim = shl2_sim(T, dev, SHL2_MSI)
    home_case("request_to_data_invalid", sim, lambda sim, ms: (
        put_slice_line(sim, ms, H, H + stride(sim), 0, 5),
        shl2_request(ms, R, 1, H + stride(sim), H)),
        lambda sim, ms: {"l2_misses": int(ms.counters.l2_misses[H]),
                         "dram_pending": int(ms.txn.dram_ready_ps[H])
                         < 2**62})
    if not out["request_to_data_invalid"]["dram_pending"]:
        bad.append("request_to_data_invalid")
    # MESI: the EXCLUSIVE fill, the silent promote, a second reader's WB
    sim = shl2_sim(T, dev, SHL2_MESI)
    st, ln = sim.state.clone(), sim._lanes.clone()
    ms = st.mem
    line = (0x100000 >> sim.params.mem.line_bits) + R
    ms.req.phase[R] = 1
    ms.req.line[R] = line
    ms.req.component[R] = 2
    ms.mail.rep_type[R] = 12
    ms.mail.rep_time[R] = 4_000_000
    check_mem_kernel("shl2_requester_fill", sim, st, ln, stats)
    s1 = line % sim.params.mem.l1d.num_sets
    states = {int(m) >> 16: (int(m) >> 8) & 0xFF for m in ms.l1d.meta[R, s1]}
    out["mesi_exclusive_fill"] = {"l1_state": states.get(line)}
    # ... R writes it: every lane's record is a store to its own line
    for t in range(T):
        ln.op[t] = 1
        ln.flags[t] = 1 | 4
        ln.active[t] = t == R
    sim.device_trace.addr0[R, :] = line << sim.params.mem.line_bits
    sim.device_trace.flags[R, :] = 1 | 4
    check_mem_kernel("shl2_requester", sim, st, ln, stats)
    states = {int(m) >> 16: (int(m) >> 8) & 0xFF for m in ms.l1d.meta[R, s1]}
    out["mesi_silent_promote"] = {
        "l1_state": states.get(line),
        "requests": int((ms.mail.req_type != 0).sum()),
        "l1d_write_hits": int(ms.counters.l1d_write_hits[R])}
    if out["mesi_exclusive_fill"]["l1_state"] != ca.EXCLUSIVE or out[
            "mesi_silent_promote"] != {"l1_state": ca.MODIFIED,
                                       "requests": 0, "l1d_write_hits": 1}:
        bad.append("mesi_exclusive_then_promote")
    # ... a second reader: the EXCLUSIVE owner gets a WB
    home_case("mesi_second_reader_downgrade", shl2_sim(T, dev, SHL2_MESI),
              lambda sim, ms: (
                  put_slice_line(sim, ms, H, H + stride(sim), 0, ca.SHARED,
                                 4, 3, (3,)),
                  shl2_request(ms, 33, 1, H + stride(sim), H)),
              lambda sim, ms: {})
    if out["mesi_second_reader_downgrade"]["messages"] != [5]:
        bad.append("mesi_second_reader_downgrade")
    # the broadcast rows: ackwise at 1,024 tiles (a NULLIFY-free EX on an
    # overflowed entry; timed, and beside it the same sweep at k = 64,
    # three copies and no row) and an upgrade's sweep at T = 40
    for label, n, k, holders in (
            (f"ackwise_row_{BIG_TILES}", BIG_TILES, 2, (3, 9, BIG_TILES - 5)),
            (f"ackwise_k64_{BIG_TILES}", BIG_TILES, 64,
             (3, 9, BIG_TILES - 5)),
            (f"ackwise_upgrade_{T}", T, 2, (3, R, 35))):
        sim = shl2_sim(n, dev, SHL2_MSI, "ackwise", k)
        home_case(label, sim, lambda sim, ms: (
            put_slice_line(sim, ms, H, H + stride(sim), 0, ca.SHARED, 1,
                           -1, holders),
            shl2_request(ms, R, 2, H + stride(sim), H)),
            lambda sim, ms: {"dir_broadcasts": int(
                ms.counters.dir_broadcasts.sum()),
                "pending": int(sum(bin(int(w) & 0xFFFFFFFF).count("1")
                                   for w in ms.txn.pending[H]))},
            timed=n == BIG_TILES)
        copies = n - 1 if k < len(holders) else len(holders)
        if out[label]["copies"] != copies or out[label][
                "dir_broadcasts"] != (k < len(holders)):
            bad.append(label)
        del sim
        torch.cuda.empty_cache()
    # limited_no_broadcast's displacement; the limitless trap
    for label, scheme in (("lnb_displacement", "limited_no_broadcast"),
                          ("limitless_trap", "limitless")):
        for k in (2, 64):
            sim = shl2_sim(T, dev, SHL2_MESI, scheme, k)
            home_case(f"{label}/k{k}", sim, lambda sim, ms: (
                put_slice_line(sim, ms, H, H + stride(sim), 0, ca.SHARED, 1,
                               -1, (3, 9, 35)),
                shl2_request(ms, R, 1, H + stride(sim), H)),
                lambda sim, ms: {"time_ps": int(ms.txn.time_ps[H])})
    if out["lnb_displacement/k2"]["messages"] != [3] or out[
            "lnb_displacement/k64"]["copies"] != 0:
        bad.append("lnb_displacement")
    if out["limitless_trap/k2"]["time_ps"] <= out["limitless_trap/k64"][
            "time_ps"]:
        bad.append("limitless_trap")
    # a fill waiting on its victim's busy eviction cell
    sim = shl2_sim(T, dev, SHL2_MESI)
    st, ln = sim.state.clone(), sim._lanes.clone()
    ms, mp = st.mem, sim.params.mem
    S1, W1 = mp.l1d.num_sets, mp.l1d.num_ways
    for t in (R, 3):
        lines = [t + 1 + i * S1 * T for i in range(W1 + 1)]
        for w, x in enumerate(lines[:W1]):
            lru = int(ms.l1d.meta[t, x % S1, w]) & 0xFF
            ms.l1d.meta[t, x % S1, w] = ca.pack(x, ca.SHARED, lru)
        ms.req.phase[t] = 1
        ms.req.line[t] = lines[W1]
        ms.req.component[t] = 2
        ms.mail.rep_type[t] = 9
        ms.mail.rep_time[t] = 6_000_000
        if t == R:
            ms.mail.evict_type[lines[W1 - 1] % T, t] = 6
    check_mem_kernel("shl2_requester_fill", sim, st, ln, stats)
    out["evict_blocked_busy_cell"] = {
        "waiting": int(ms.req.phase[R]), "filled_other": int(ms.req.phase[3])
        == 0}
    if out["evict_blocked_busy_cell"] != {"waiting": 1,
                                          "filled_other": True}:
        bad.append("evict_blocked_busy_cell")
    del sim, st, ln
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"shared-L2 edge states missed their branch: "
                             f"{bad}")
    return out


def count_misses(sim) -> int:
    c = sim.state.mem.counters
    return int((c.l1i_misses + c.l1d_read_misses + c.l1d_write_misses)
               .sum())


def shl2_requester_lanes(ctx, ms, ln, trace, core, en) -> dict:
    """`shl2_requester`'s lanes at this state, from its plain version's own
    predicates: those that start a slot; those that look their slot's L1
    row up (every start but an instruction-buffer hit), by cache; the
    misses; and the hits that write their row back (an LRU touch, or
    under MESI the E -> M promote of a write hit)."""
    import torch

    from graphite_tpu_torch.memory import cache_array as ca
    from graphite_tpu_torch.memory.common import (
        U32, next_present_slot, slots_present,
    )
    from graphite_tpu_torch.memory.context import MemRec
    from graphite_tpu_torch.trace.schema import (
        FLAG_MEM0_WRITE, FLAG_MEM1_WRITE,
    )

    mp = ctx.mp
    rec = MemRec.fetch(ln, trace, core.idx)
    slot = next_present_slot(slots_present(mp, rec.op, rec.flags, en),
                             ms.req.slot)
    start = ln.active & (ms.req.phase == 0) & (slot < 3)
    icache = slot == 0
    addr = torch.where(icache, rec.pc & U32,
                       torch.where(slot == 1, rec.addr0, rec.addr1))
    line = (addr >> mp.line_bits).to(torch.int32)
    write = ~icache & torch.where(slot == 1,
                                  (rec.flags & FLAG_MEM0_WRITE) != 0,
                                  (rec.flags & FLAG_MEM1_WRITE) != 0)
    look = start & ~(icache & (line == ms.req.instr_buf))
    _, _, s_i = ca.row_lookup(
        ca.gather_row(ms.l1i.meta, line, ctx.l1i_sets), line)
    _, _, s_d = ca.row_lookup(
        ca.gather_row(ms.l1d.meta, line, ctx.l1d_sets), line)
    state = torch.where(icache, s_i, s_d)
    hit = look & torch.where(write, ca.state_writable(state),
                             ca.state_readable(state))
    touch = ((icache & (mp.l1i.replacement != "round_robin"))
             | (~icache & (mp.l1d.replacement != "round_robin")))
    back = hit & (touch | (write & (state == ca.EXCLUSIVE)))
    return {"start": start, "look_i": look & icache,
            "look_d": look & ~icache, "miss": look & ~hit,
            "back_i": back & icache, "back_d": back & ~icache}


def shl2_work(name, ctx, ms, ln, trace, core, en):
    """A shared-L2 kernel's work at the state it meets, as a 0-d tensor on
    the state's device: the lanes that start a slot (`shl2_requester`),
    the homes with no transaction that resume a saved request or have one
    to pop (`shl2_home_start`), the replies a waiting requester consumes
    (`shl2_requester_fill`)."""
    import torch

    if name == "shl2_requester":
        return shl2_requester_lanes(ctx, ms, ln, trace, core,
                                    en)["start"].sum()
    if name == "shl2_home_start":
        T = ctx.mp.n_tiles
        live = ms.mail.req_type != 0
        cell = torch.where(live, ms.mail.req_home.to(torch.int64), T)
        has = torch.zeros(T + 1, dtype=torch.int32, device=live.device)
        has.scatter_(0, cell, 1)
        return (((has[:T] > 0) | ms.txn.saved_valid)
                & ~ms.txn.active).sum()
    return ((ms.req.phase == 1) & (ms.mail.rep_type != 0)).sum()


class Shl2Probe:
    """While entered, each shared-L2 kernel's work (`shl2_work`) at the
    state it meets in the engine's step, recorded call by call on the card
    with no host read."""

    def __init__(self):
        self.work = {k: [] for k in SHL2_KERNELS}

    def __enter__(self):
        from graphite_tpu_torch.memory import engine_shl2

        self.saved = {k: getattr(engine_shl2, k) for k in SHL2_KERNELS}
        work = self.work

        def requester(ctx, ms, lanes, trace, core, en, progress, **kw):
            work["shl2_requester"].append(shl2_work(
                "shl2_requester", ctx, ms, lanes, trace, core, en))
            self.saved["shl2_requester"](ctx, ms, lanes, trace, core, en,
                                         progress, **kw)

        def home_start(ctx, ms, freq, en, progress):
            work["shl2_home_start"].append(shl2_work(
                "shl2_home_start", ctx, ms, None, None, None, en))
            self.saved["shl2_home_start"](ctx, ms, freq, en, progress)

        def fill(ctx, ms, lanes, trace, core, en, progress, *a, **kw):
            work["shl2_requester_fill"].append(shl2_work(
                "shl2_requester_fill", ctx, ms, lanes, trace, core, en))
            self.saved["shl2_requester_fill"](ctx, ms, lanes, trace, core,
                                              en, progress, *a, **kw)

        for k, f in zip(SHL2_KERNELS, (requester, home_start, fill)):
            setattr(engine_shl2, k, f)
        return self

    def __exit__(self, *exc):
        from graphite_tpu_torch.memory import engine_shl2

        for k, f in self.saved.items():
            setattr(engine_shl2, k, f)

    def take(self) -> dict:
        """The work recorded since the last take, call by call, as ints."""
        import torch

        out = {k: torch.stack(v).tolist() if v else []
               for k, v in self.work.items()}
        for v in self.work.values():
            v.clear()
        return out


def kernel_at(name, sim, st, ln) -> dict:
    """One shared-L2 kernel's times and bound at (st, ln) (`fresh_times`:
    its device µs from CUDA graphs of 100 calls, each after a restore of
    every tensor it binds, less the restores alone; its eager call's host
    µs; its plain version's µs to the card's end)."""
    t = fresh_times(name, sim, sim_ctx(sim), st, ln)
    b_ms, b_by, nbytes, _ = mem_bound(name, sim, st, ln)
    return {"us": t["ms"] * 1e3, "eager_us": t["call_ms"] * 1e3,
            "plain_us": t["plain_ms"] * 1e3, "bound_us": b_ms * 1e3,
            "bound_by": b_by, "bytes": nbytes}


def shl2_kernel_at(name, sim, ctx, st, ln) -> dict:
    """`name` timed in the iteration that starts at (st, ln), at the state
    it meets there (the step's units before it run as the card runs
    them), with its work at that state (`shl2_work`)."""
    mctx, en = sim.models.mem, st.models_enabled
    check_kernel("lane_fetch_cost", ctx, st, ln, new_stats())
    (middle,) = mctx.phase_graphs.get(mctx, st.mem, en, st.core.freq_mhz,
                                      ln.progress)
    for k in SHL2_KERNELS:
        if k == name:
            break
        mem_call(k, sim, st, ln, plain=False)
        if k == "shl2_requester":
            mctx.phase_graphs.replay(middle)
    out = kernel_at(name, sim, st, ln)
    out["work"] = int(shl2_work(name, mctx, st.mem, ln, sim.device_trace,
                                st.core, en))
    return out


def phase_shl2_window(dev, batch, stats) -> dict:
    """The slice's main path checked at its own shapes: canneal at 1,024
    tiles on shared-L2 MESI (full_map) run by `run_chunk(1)` over its
    first SHL2_SCAN quanta, the first quantum with the most fills (replies
    consumed) taken; that quantum replayed from its start, iteration by
    iteration at its boundary, to count each iteration's L1 misses and
    each kernel's work at the state it meets (`Shl2Probe`); the
    SHL2_WINDOW iterations with the most misses checked kernel by kernel
    against the plain versions (max abs err 0); and each kernel timed at
    the iteration where its own work peaks."""
    import torch

    from graphite_tpu_torch.engine.step import subquantum_iteration

    sim = mem_sim(batch.op.shape[0], batch, dev, clock_scheme="lax_barrier",
                  extra=scheme_extra("full_map", SHL2_K, SHL2_MESI))
    t0 = time.perf_counter()
    best = None
    with Shl2Probe() as probe:
        for q in range(SHL2_SCAN):
            start = sim.state.clone()
            done, n = sim.run_chunk(1)
            fills = sum(probe.take()["shl2_requester_fill"])
            if best is None or fills > best[1]:
                best = (start, fills, q, sim.last_n_iterations)
            else:
                del start
            if done or not n:
                break
    start, q_fills, q_at, iters = best
    find_s = time.perf_counter() - t0

    def replay(n):
        sim.state = start.clone()
        qend = quantum_end(sim)
        for _ in range(n):
            subquantum_iteration(sim.params, sim.device_trace, sim.state,
                                 qend, sim._lanes, sim._cost_table,
                                 sim.models)
        return Ctx(sim.params, sim.device_trace, qend, sim._cost_table,
                   sim.models)

    ctx = replay(0)
    per_it = []
    with Shl2Probe() as probe:
        for _ in range(iters):
            m0 = count_misses(sim)
            subquantum_iteration(sim.params, sim.device_trace, sim.state,
                                 ctx.qend, sim._lanes, sim._cost_table,
                                 sim.models)
            per_it.append(count_misses(sim) - m0)
        work = probe.take()
    if any(len(v) != iters for v in work.values()):
        raise AssertionError("canneal/shl2: a kernel not called once an "
                             "iteration in the replayed quantum")
    timed = {}
    for name in SHL2_KERNELS:
        w = work[name]
        peak = max(range(iters), key=w.__getitem__)
        ctx = replay(peak)
        timed[name] = shl2_kernel_at(name, sim, ctx, sim.state, sim._lanes)
        timed[name].update(timed_iteration=peak, peak_work=w[peak],
                           mean_work=sum(w) / iters)
    width = min(SHL2_WINDOW, iters)
    sums = [sum(per_it[i:i + width]) for i in range(iters - width + 1)]
    at = max(range(len(sums)), key=sums.__getitem__)
    ctx = replay(at)
    st, ln = sim.state, sim._lanes
    t0 = time.perf_counter()
    checked = 0
    for _ in range(width):
        checked_iteration(ctx, st, ln, stats, sim=sim)
        checked += 1
        if bool(st.done.all()):
            break
    torch.cuda.synchronize()
    out = {"workload": "canneal/shl2_mesi/full_map",
           "tiles": sim.params.n_tiles,
           "sharer_words": sim.params.mem.sharer_words,
           "dir_word_bytes": sim.state.mem.dir.word.numel() * 8,
           "dir_sharers_bytes": sim.state.mem.dir.sharers.numel() * 4,
           "quantum": q_at, "find_s": find_s, "quantum_iterations": iters,
           "quantum_fills": q_fills, "quantum_misses": sum(per_it),
           "window_from_iteration": at,
           "window_misses": sum(per_it[at:at + width]),
           "checked_iterations": checked,
           "checked_s": time.perf_counter() - t0, "kernels": timed}
    del sim, start, st, ln
    torch.cuda.empty_cache()
    if out["window_misses"] <= 0:
        raise AssertionError("canneal/shl2: no miss in the checked window")
    return out


def phase_shl2_full_width(dev, batch, build_s) -> list:
    """canneal at 1,024 tiles (4,096-line footprint) on
    `config_text(1024, shared_mem=True, protocol="pr_l1_sh_l2_mesi",
    clock_scheme="lax_barrier")`, full_map, the slice's main path, once to
    completion with the launch counts from 0: func_errors 0, each shared-L2
    kernel launched once an iteration, no private-L2 memory kernel
    launched; then the same under pr_l1_sh_l2_msi."""
    import torch

    rows = []
    for protocol in (SHL2_MESI, SHL2_MSI):
        sim = mem_sim(batch.op.shape[0], batch, dev,
                      clock_scheme="lax_barrier",
                      extra=scheme_extra("full_map", SHL2_K, protocol))
        row = workload_row(f"canneal/{protocol.removeprefix('pr_l1_')}",
                           sim, dev, ("lane_fetch_cost", "barrier_sync",
                                      "lane_commit") + SHL2_KERNELS)
        it = row["iterations"]
        if any(row["launches"][k] != it for k in SHL2_KERNELS):
            raise AssertionError(f"{row['workload']}: a shared-L2 kernel "
                                 "not launched once an iteration")
        private = [k for k in MEM_KERNELS + (HOME_EXT,)
                   if row["launches"].get(k)]
        if private:
            raise AssertionError(f"{row['workload']} launched {private}")
        cnt = sim.state.mem.counters
        row.update(protocol=protocol, trace_build_s=build_s,
                   us_per_iteration=row["wall_s"] / it * 1e6,
                   **{k: int(getattr(cnt, k).sum()) for k in (
                       "dram_reads", "dram_writes", "dir_broadcasts",
                       "invalidations", "evictions", "dir_accesses")})
        if row["func_errors"]:
            raise AssertionError(f"{row['workload']}: functional errors")
        rows.append(row)
        del sim
        torch.cuda.empty_cache()
    return rows


def net_kernel_us(t: dict) -> dict:
    """A `time_net_kernels` entry in µs."""
    out = {"us": t["ms"] * 1e3, "call_us": t["call_ms"] * 1e3,
           "plain_us": t["plain_ms"] * 1e3, "bound_us": t["bound_ms"] * 1e3,
           "bytes": t["bytes"]}
    if "packets" in t:
        out["packets"] = t["packets"]
    if "all_tiles" in t:
        out["all_tiles"] = net_kernel_us(t["all_tiles"])
    return out


def is_kernel(key: str, name: str) -> bool:
    """Whether a profiler key names `name`'s kernel (a template
    instantiation's key starts with its return type)."""
    return key.removeprefix("void ").startswith(name + "_kernel")


def ptxas_summary(logs: dict) -> dict:
    """Registers, shared memory and spills of each kernel function, from
    nvcc's -Xptxas=-v output."""
    out = {}
    for name, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        out[name] = lines
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run",
              file=sys.stderr)
        return 2
    from graphite_tpu_torch import ops   # noqa: F401 (fails outside the repo)

    # the one worker process (on one thread) that runs the CPU sides of
    # the card-vs-CPU cases while the card works
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"),
        initializer=one_thread)
    try:
        return phases(pool)
    finally:
        pool.shutdown(cancel_futures=True)


def phases(pool) -> int:
    """Every phase in order, then the kernels line, the card's line and
    the last line; `pool` runs the CPU sides of the card-vs-CPU cases."""
    import torch

    from graphite_tpu_torch import ops
    from graphite_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    build_s = build.build_all()
    emit({"phase": "build", "seconds": build_s,
          "kernels": list(ops.KERNELS), "libraries": list(build.KERNEL_NAMES),
          "card": smi, "ptxas": ptxas_summary(build.BUILD_LOGS)})

    from graphite_tpu_torch.trace.benchmarks import fft_trace

    batch = fft_trace(1024, points_per_tile=2048)
    stats = new_stats()
    kinfo = phase_kernels(dev, batch, stats)
    for name in KERNEL_ORDER:
        row = {"phase": "kernel", "name": name, "card": smi,
               "checks_equal": stats[name]["checks"]}
        for state, tm in kinfo["timings"].items():
            if name not in tm:
                continue
            t = tm[name]
            row[state] = {
                "us": t["ms"] * 1e3, "call_us": t["call_ms"] * 1e3,
                "plain_us": t["plain_ms"] * 1e3,
                "bound_us": t["bound_ms"] * 1e3, "bytes": t["bytes"]}
            row[state]["call_unbound_us"] = t["call_unbound_ms"] * 1e3
        emit(row)
    emit({"phase": "kernels_checked", "card": smi,
          "iterations_checked": kinfo["iterations_checked"],
          "checked_s": kinfo["checked_s"],
          "barrier_phase_at": kinfo["barrier_phase_at"],
          "edge_cases": kinfo["edge_cases"]})

    phase_end_to_end(dev, smi)
    full, sim, init = phase_full_width(dev, batch)
    emit({"phase": "full_width", "card": smi, **full})
    states = {**TIMING_AT, "barrier_phase": kinfo["barrier_phase_at"]}
    for state, at in states.items():
        # the inner block of the run that holds the timing state
        start = at // sim.params.inner_block * sim.params.inner_block
        prof = checked_profile(sim, init, start, full["wall_s_median"]
                               / full["iterations"], KERNEL_ORDER, 0,
                               f"headline ({state})")
        emit({"phase": "profile", "state": state, "card": smi, **prof})

    # the memory slice: the 64-tile iocoom + MSI FFT companion
    minfo = phase_memory_kernels(dev, stats)
    for name in MEM_KERNELS + ("lane_commit",):
        t = minfo["timings"][name]
        emit({"phase": "memory_kernel", "name": name, "card": smi,
              "checks_equal": stats[name]["checks"],
              "miss_heavy": {"us": t["ms"] * 1e3,
                             "call_us": t["call_ms"] * 1e3,
                             "plain_us": t["plain_ms"] * 1e3,
                             "bound_us": t["bound_ms"] * 1e3,
                             "bytes": t["bytes"]}})
    emit({"phase": "memory_kernels_checked", "card": smi,
          **{k: v for k, v in minfo.items() if k != "timings"}})
    phase_memory_end_to_end(dev, smi)
    comp, csim, cinit = phase_companion(dev)
    emit({"phase": "companion", "card": smi, **comp})
    at = minfo["miss_heavy_at"]
    start = at // csim.params.inner_block * csim.params.inner_block
    # the device trace has dropped the window's first launch of some
    # kernels (the first two of the companion's iteration)
    prof = checked_profile(csim, cinit, start, comp["wall_s_median"]
                           / comp["iterations"], KERNEL_ORDER + MEM_KERNELS,
                           1, "companion")
    emit({"phase": "companion_profile", "card": smi, **prof})
    del csim, cinit
    torch.cuda.empty_cache()

    # the contention NoCs of the USER net: RADIX under hop-by-hop and ATAC
    ninfo = phase_noc_kernels(dev, stats)
    for name in NOC_KERNELS:
        row = {"phase": "noc_kernel", "name": name, "card": smi,
               "checks_equal": stats[name]["checks"],
               **{k: v for k, v in ninfo[name].items() if k != "timings"}}
        for unit, t in ninfo[name]["timings"].items():
            row[unit] = {"us": t["ms"] * 1e3, "call_us": t["call_ms"] * 1e3,
                         "plain_us": t["plain_ms"] * 1e3,
                         "bound_us": t["bound_ms"] * 1e3,
                         "bytes": t["bytes"]}
        emit(row)
    emit({"phase": "noc_edge_cases", "card": smi,
          "cases": noc_edge_cases(dev, stats)})
    phase_noc_end_to_end(dev, smi)
    radix = {}
    for name in NOC_KERNELS:
        rinfo, rsim, rinit = phase_radix(dev, name)
        emit({"phase": "radix", "card": smi, **rinfo})
        # the first inner block wholly inside the first all-to-all
        ib = rsim.params.inner_block
        start = (ninfo[name]["all_to_all_at"] // ib + 1) * ib
        # the device trace can drop the window's first two iterations
        # (observed: 62 of 64 for every kernel)
        prof = checked_profile(rsim, rinit, start, rinfo["wall_s_median"]
                               / rinfo["iterations"], KERNEL_ORDER + (name,),
                               2, f"RADIX ({NOC_NETS[name]})")
        emit({"phase": "radix_profile", "network": NOC_NETS[name],
              "card": smi, **prof})
        radix[name] = rinfo
        del rsim, rinit
        torch.cuda.empty_cache()

    # the contention nets as the MEMORY net: the MSI engine's routes; the
    # CPU sides of its card-vs-CPU cases, and then of the MOSI slice's,
    # run meanwhile in one process
    cpu_runs = start_net_e2e_cpu(pool)
    mosi_cpu = start_mosi_cpu(pool)
    shl2_cpu = start_shl2_cpu(pool, SHL2_E2E_CASES + SHL2_NET_CASES)
    nk = phase_memory_net_kernels(dev, stats)
    for net in MEM_NETS:
        emit({"phase": "memory_net_kernel", "memory_net": net,
              "card": smi,
              **{k: v for k, v in nk[net].items() if k != "timings"},
              **{name: net_kernel_us(t)
                 for name, t in nk[net]["timings"].items()}})
    emit({"phase": "memory_net_edge_cases", "card": smi,
          "cases": mem_net_edge_cases(dev, stats)})
    phase_memory_net_end_to_end(dev, smi, cpu_runs)
    ncomp = {}
    for net in MEM_NETS:
        ncomp[net], nsim, ninit = phase_net_companion(dev, net)
        emit({"phase": "memory_net_companion", "card": smi, **ncomp[net]})
        ib = nsim.params.inner_block
        start = nk[net]["miss_heavy_at"] // ib * ib
        # the graph of phases 4-5 launches `mem_net_route` twice a call
        prof = checked_profile(
            nsim, ninit, start, ncomp[net]["wall_s_median"]
            / ncomp[net]["iterations"],
            KERNEL_ORDER + MEM_KERNELS + ("mem_net_route",), 1,
            f"{net} companion", per_call={"mem_net_route": 2})
        emit({"phase": "memory_net_companion_profile", "memory_net": net,
              "card": smi, **prof})
        del nsim, ninit
        torch.cuda.empty_cache()

    emit({"phase": "north_star", "card": smi, **phase_north_star(dev)})
    torch.cuda.empty_cache()
    emit({"phase": "north_star_hop_by_hop", "card": smi,
          **phase_hbh_north_star(dev)})
    torch.cuda.empty_cache()

    # the outputs slice: lax_p2p, barrier_host, the generators, outputs
    pinfo = phase_p2p_kernel(dev, batch, stats)
    p2p_t = pinfo.pop("timings")
    emit({"phase": "p2p_kernel", "card": smi,
          "checks_equal": stats[P2P_KERNEL]["checks"], **pinfo,
          **{state: {name: {"us": t[name]["ms"] * 1e3,
                            "call_us": t[name]["call_ms"] * 1e3,
                            "plain_us": t[name]["plain_ms"] * 1e3,
                            "bound_us": t[name]["bound_ms"] * 1e3,
                            "bytes": t[name]["bytes"]}
                     for name in KERNEL_ORDER}
             for state, t in p2p_t.items()}})
    emit({"phase": "p2p_edge_cases", "card": smi,
          "cases": p2p_edge_cases(dev, stats)})
    for name, build_sim in p2p_e2e_cases():
        emit({"phase": "p2p_end_to_end", "card": smi,
              **card_vs_cpu(name, build_sim, dev)})
    p2p_full = phase_p2p_full_width(dev, batch, full, sim, init)
    emit({"phase": "p2p_full_width", "card": smi, **p2p_full})
    torch.cuda.empty_cache()
    for row in phase_workloads(dev):
        emit({"phase": "workloads", "card": smi, **row})
    torch.cuda.empty_cache()
    emit({"phase": "outputs", "card": smi, **phase_outputs(dev)})

    # MOSI and the four limited directory schemes on the private-L2 engine
    emit({"phase": "mosi_edge_cases", "card": smi,
          "cases": mosi_edge_cases(dev, stats)})
    phase_mosi_end_to_end(dev, smi, stats, mosi_cpu)
    mt = mosi_kernel_times(dev)
    for name, t in mt["timings"].items():
        msi = minfo["timings"][name]
        emit({"phase": "mosi_kernel",
              "name": HOME_EXT if name == "mem_home_start" else name,
              "card": smi,
              "state": "companion miss-heavy, MOSI + ackwise (k = 4)",
              "miss_heavy_at": mt["miss_heavy_at"],
              "mosi_ackwise": {"us": t["ms"] * 1e3,
                               "call_us": t["call_ms"] * 1e3,
                               "plain_us": t["plain_ms"] * 1e3,
                               "bound_us": t["bound_ms"] * 1e3,
                               "bytes": t["bytes"]},
              "msi_full_map_us": msi["ms"] * 1e3})
    torch.cuda.empty_cache()
    from graphite_tpu_torch.trace.benchmarks import canneal_trace

    t0 = time.perf_counter()
    canneal = canneal_trace(1024)
    canneal_s = time.perf_counter() - t0
    emit({"phase": "mosi_window", "card": smi,
          **phase_mosi_window(dev, canneal, stats)})
    mosi_full = phase_mosi_full_width(dev, canneal, canneal_s)
    for row in mosi_full:
        emit({"phase": "mosi_full_width", "card": smi, **row})
    torch.cuda.empty_cache()

    # the shared-L2 engine: pr_l1_sh_l2_msi / _mesi
    emit({"phase": "shl2_edge_cases", "card": smi,
          "cases": shl2_edge_cases(dev, stats)})
    phase_shl2_end_to_end(dev, smi, stats, shl2_cpu)
    shl2_win = phase_shl2_window(dev, canneal, stats)
    emit({"phase": "shl2_window", "card": smi, **shl2_win})
    shl2_full = phase_shl2_full_width(dev, canneal, canneal_s)
    for row in shl2_full:
        emit({"phase": "shl2_full_width", "card": smi, **row})

    rows = []
    send = kinfo["timings"]["send_phase"]
    for name in KERNEL_ORDER + MEM_KERNELS + NOC_KERNELS + (
            "mem_net_route", P2P_KERNEL, HOME_EXT) + SHL2_KERNELS:
        mem = name in MEM_KERNELS
        if name in SHL2_KERNELS:
            # timed at the 1,024-tile MESI canneal's iteration where its
            # own work peaks; launched by its run to completion
            t = shl2_win["kernels"][name]
            tm = {"ms": t["us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
                  "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"]}
            path = shl2_full[0]
        elif name == P2P_KERNEL:
            tm, path = p2p_t["send_phase"]["lane_fetch_cost"], p2p_full
        elif name == HOME_EXT:
            # timed at the MOSI + ackwise companion's miss-heavy state;
            # launched by the 1,024-tile MOSI + ackwise canneal
            tm, path = mt["timings"]["mem_home_start"], mosi_full[0]
        elif name in NOC_KERNELS:
            tm, path = ninfo[name]["timings"][name], radix[name]
        elif name == "mem_net_route":
            tm = nk[MEM_NETS[0]]["timings"][name]
            path = ncomp[MEM_NETS[0]]
        else:
            tm = minfo["timings"][name] if mem else send[name]
            path = comp if mem else full
        rows.append({
            "name": name, "route": "cuda",
            "source": ops.KERNELS[name].source,
            "replaces": REPLACES[name],
            "launches": path["launches"][name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None,
            "status": "equal" if stats[name]["checks"] > 0 else "unchecked",
        })
    if any(r["status"] != "equal" for r in rows):
        raise AssertionError("a kernel was never checked")
    emit({"kernels": rows})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


AB_WORKLOADS = ("headline", "companion", "north_star", "mem_kernels")


def ab_in(workload: str, tree: str) -> int:
    """One process of `ab`: `workload` with the package of `tree` — the
    headline or the companion warmed up, then RUNS / MEM_RUNS timed runs
    from one initial state; or the north star (its kernels built) timed
    once."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    dev = torch.device("cuda", 0)
    if workload == "mem_kernels":
        # the three memory kernels' device times at the companion's first
        # miss-heavy state (its iterations up to there checked)
        sim = companion(dev)
        found = {}

        def watch(i, st, ln):
            if "at" not in found and miss_heavy(sim, st):
                found["at"] = i
                found["state"] = (st.clone(), ln.clone())

        run_checked(sim, COMPANION_CHECKED, new_stats(), watch)
        sim.state, sim._lanes = found["state"]
        t = time_mem_kernels(sim, *found["state"])
        emit({"kernels_us": {k: t[k]["ms"] * 1e3 for k in MEM_KERNELS[:3]},
              "walls": [], "iterations": found["at"],
              "total_instructions": 0})
        return 0
    if workload in ("headline", "companion"):
        if workload == "headline":
            from graphite_tpu_torch.trace.benchmarks import fft_trace

            sim = make_sim(1024, fft_trace(1024, points_per_tile=2048), dev,
                           inner_block=64)
        else:
            sim = companion(dev)
        init = sim.state._map(lambda t: t.to("cpu", copy=True))
        sim.warmup()
        runs = RUNS if workload == "headline" else MEM_RUNS
    else:
        from graphite_tpu_torch.ops.build import build_all
        from graphite_tpu_torch.trace.benchmarks import fft_trace

        build_all()
        sim = mem_sim(1024, fft_trace(1024, points_per_tile=2048,
                                      use_memory=True), dev,
                      clock_scheme="lax_barrier")
        runs = 1
    walls = []
    for _ in range(runs):
        if workload != "north_star":
            sim.state = init._map(lambda t: t.to(dev, copy=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sim.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    emit({"walls": walls, "iterations": sim.last_n_iterations,
          "total_instructions": r.total_instructions})
    return 0


def ab(workload: str, trees) -> int:
    """`python3 chip_smoke.py --ab headline|companion|north_star|mem_kernels
    TREE...`: the workload timed with the `graphite_tpu_torch` package of
    each TREE (a directory that holds one, e.g. a `git archive` unpacked
    into the git-ignored `_archive/`), each in a process of its own, the
    trees in order and then in reverse (A B B A).  A JSON line a process,
    one a tree (its walls, their median and spread; for mem_kernels each
    memory kernel's device µs at the companion's miss-heavy state), then
    the card's name and power limit."""
    import torch

    if workload not in AB_WORKLOADS or not trees:
        print(f"chip_smoke: --ab {'|'.join(AB_WORKLOADS)} TREE...",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    walls = {t: [] for t in trees}
    kus = {t: {} for t in trees}
    first = {}
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ab-in", workload, tree],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        key = (res["iterations"], res["total_instructions"])
        if first.setdefault(tree, key) != key:
            raise AssertionError(f"{tree}: the {workload} changed its "
                                 "result")
        walls[tree] += res["walls"]
        for k, us in res.get("kernels_us", {}).items():
            kus[tree].setdefault(k, []).append(us)
        emit({"tree": tree, "workload": workload, **res})
    if workload == "mem_kernels":
        for tree, ks in kus.items():
            emit({"tree": tree, "workload": workload,
                  **{k: {"us": v, "median": statistics.median(v)}
                     for k, v in ks.items()}})
        print(smi_line(), flush=True)
        return 0
    for tree, w in walls.items():
        med = statistics.median(w)
        emit({"tree": tree, "workload": workload, "runs": len(w),
              "median": med, "min": min(w), "max": max(w),
              "spread": max(w) - min(w),
              "us_per_iteration_median": med / first[tree][0] * 1e6})
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        sys.exit(ab(sys.argv[2] if len(sys.argv) > 2 else "",
                    sys.argv[3:]))
    if sys.argv[1:2] == ["--ab-in"]:
        sys.exit(ab_in(sys.argv[2], sys.argv[3]))
    sys.exit(main())

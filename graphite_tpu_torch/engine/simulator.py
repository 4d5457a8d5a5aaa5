"""Host-side orchestration: config -> EngineParams, state, run, results.

Port of `graphite_tpu/engine/simulator.py` for the path this package
supports: the simple in-order and the iocoom cores (mixed per tile by
`[tile] model_list`), without a memory subsystem, with the private-L1/L2
MSI or MOSI directory protocol or with the shared-L2 MSI or MESI protocol
(`pr_l1_sh_l2_*`, memory/engine_shl2.py; any of the five directory
schemes), the magic,
emesh_hop_counter, emesh_hop_by_hop or atac network as the USER and as
the MEMORY net, and the `lax`, `lax_barrier` and `lax_p2p` clock-skew
schemes (`lax_barrier` also host-driven, `barrier_host`), resident on one
device.  `SimResults`, `summary()`, `write_output()`, `DeadlockError` and
`MailboxOverflowError` match the JAX package.

Every other configuration raises `NotImplementedError` naming the
ROADMAP.md queue-1 item that ports it — the port never silently runs
something else.  `device=None` means `cuda:0`, and raises when CUDA is
absent: CPU runs must ask for `device="cpu"`.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from graphite_tpu_torch.config.config_file import ConfigFile
from graphite_tpu_torch.config.simconfig import SimConfig
from graphite_tpu_torch.engine.loop import run_simulation
from graphite_tpu_torch.engine.state import (
    DeviceTrace, DvfsState, Lanes, SimState, init_state,
)
from graphite_tpu_torch.engine.step import (
    PLAIN_UNROLL_MAX, EngineParams, ModelCtx, cost_table_tensor,
    units_for_ops,
)
from graphite_tpu_torch.memory.context import MemCtx
from graphite_tpu_torch.memory.engine import line_census
from graphite_tpu_torch.memory.engine_shl2 import shl2_line_census
from graphite_tpu_torch.memory.params import MemParams
from graphite_tpu_torch.memory.state import (
    COUNTER_NAMES, SHL2_PHASE_NAMES, init_mem_state, init_shl2_state,
)
from graphite_tpu_torch.models.dvfs import DvfsParams, module_freq_mhz
from graphite_tpu_torch.models.iocoom import IocoomParams, init_iocoom_state
from graphite_tpu_torch.models.network_atac import AtacParams, init_atac_state
from graphite_tpu_torch.models.network_hop_by_hop import (
    HopByHopParams, init_noc_state,
)
from graphite_tpu_torch.models.network_user import UserNetworkParams
from graphite_tpu_torch.time_types import cycles_to_ps, ns_to_ps, ps_to_ns
from graphite_tpu_torch.trace.schema import (
    FLAG_MEM0_VALID, FLAG_MEM1_VALID, STATIC_COST_KEYS, Op, TraceBatch,
)


class DeadlockError(RuntimeError):
    pass


class MailboxOverflowError(RuntimeError):
    pass


def check_card_limits(params: EngineParams, n_barriers: int) -> None:
    """Raise the `ValueError` a one-CTA kernel of this path would raise at
    its first launch on a card: `mem_requester`, `mem_requester_fill`
    (the shared-L2 engine: `shl2_requester`, `shl2_home_start`,
    `shl2_requester_fill`) and (under a contention MEMORY net)
    `mem_net_route` past 1,024 tiles, `atac_route` past 1,024 lanes,
    `barrier_sync` past 1,024 barriers.  `Simulator` calls it for a CUDA
    device; CPU runs take the plain versions, which have no such
    limit."""
    from graphite_tpu_torch.ops.atac_route import MAX_LANES
    from graphite_tpu_torch.ops.barrier_sync import MAX_BARRIERS
    from graphite_tpu_torch.ops.build import check_width
    from graphite_tpu_torch.ops.mem_net_route import MAX_PACKETS
    from graphite_tpu_torch.ops.mem_requester import MAX_TILES

    T = params.n_tiles
    mp = params.mem
    if mp is not None:
        names = (("shl2_requester", "shl2_home_start", "shl2_requester_fill")
                 if mp.is_shl2 else ("mem_requester", "mem_requester_fill"))
        for name in names:
            check_width(name, T, MAX_TILES, "tiles")
        if mp.net_hbh is not None or mp.net_atac is not None:
            check_width("mem_net_route", T, MAX_PACKETS, "packets")
    if params.user_atac is not None:
        check_width("atac_route", T, MAX_LANES, "lanes")
    if "barrier" in params.units:
        check_width("barrier_sync", n_barriers, MAX_BARRIERS, "barriers")


def mem_phase_names(params: EngineParams) -> tuple:
    """The memory engine's phase names, in its skip-vector order
    (`graphite_tpu/engine/simulator.py:285-292`)."""
    if params.mem.is_shl2:
        return SHL2_PHASE_NAMES
    return ("requester", "home_evict", "home_start", "sharer",
            "home_finish", "requester_fill")


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to graphite_tpu_torch yet (ROADMAP.md "
        f"queue 1, item {item})")


def resolve_device(device) -> torch.device:
    """`None` -> cuda:0; raises without CUDA (no silent CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "graphite_tpu_torch runs on cuda:0 by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass
class SimResults:
    """Final counters, mirroring the `sim.out` summary structure
    (`core_model.cc:90-115`, `tile.cc:105-123`); same fields as the JAX
    package's `SimResults` (the observability ones, telemetry, profile and
    hist, are always empty here)."""

    n_tiles: int
    completion_time_ps: int
    instruction_count: np.ndarray
    clock_ps: np.ndarray
    memory_stall_ps: np.ndarray
    execution_stall_ps: np.ndarray
    recv_instructions: np.ndarray
    recv_stall_ps: np.ndarray
    sync_instructions: np.ndarray
    sync_stall_ps: np.ndarray
    bp_correct: np.ndarray
    bp_incorrect: np.ndarray
    packets_sent: np.ndarray
    packets_received: np.ndarray
    total_packet_latency_ps: np.ndarray
    n_quanta: int
    mem_counters: "dict | None" = None
    func_errors: int = 0
    detailed_stalls: "dict | None" = None
    telemetry: "object | None" = None
    profile: "object | None" = None
    hist: "object | None" = None

    @property
    def total_instructions(self) -> int:
        return int(self.instruction_count.sum())

    def summary(self) -> str:
        """sim.out-style per-tile summary (`simulator.cc:152-170`)."""
        out = ["Simulation Summary",
               "Target Completion Time (in nanoseconds): "
               f"{ps_to_ns(self.completion_time_ps)}",
               f"Total Instructions: {self.total_instructions}"]
        for t in range(self.n_tiles):
            out.append(f"Tile {t} Summary:")
            out.append("  Core Summary:")
            out.append("    Total Instructions: "
                       f"{int(self.instruction_count[t])}")
            out.append("    Completion Time (in nanoseconds): "
                       f"{ps_to_ns(int(self.clock_ps[t]))}")
            out.append("    Synchronization Stalls: "
                       f"{int(self.sync_instructions[t])}")
            out.append("    Network Recv Stalls: "
                       f"{int(self.recv_instructions[t])}")
            out.append("    Stall Time Breakdown (in nanoseconds): ")
            out.append("      Memory: "
                       f"{ps_to_ns(int(self.memory_stall_ps[t]))}")
            out.append("      Execution Unit: "
                       f"{ps_to_ns(int(self.execution_stall_ps[t]))}")
            out.append("      Synchronization: "
                       f"{ps_to_ns(int(self.sync_stall_ps[t]))}")
            out.append("      Network Recv: "
                       f"{ps_to_ns(int(self.recv_stall_ps[t]))}")
            if self.detailed_stalls is not None:
                out.extend(self._detailed_summary(t))
            bp_total = int(self.bp_correct[t] + self.bp_incorrect[t])
            if bp_total:
                out.append("    Branch Predictor:")
                out.append(f"      Num Correct: {int(self.bp_correct[t])}")
                out.append("      Num Incorrect: "
                           f"{int(self.bp_incorrect[t])}")
            if self.mem_counters is not None:
                out.extend(self._cache_summary(t))
            out.append("  Network Summary (USER):")
            out.append(f"    Packets Sent: {int(self.packets_sent[t])}")
            out.append("    Packets Received: "
                       f"{int(self.packets_received[t])}")
            if self.packets_received[t]:
                avg = (self.total_packet_latency_ps[t]
                       / self.packets_received[t] / 1000)
                out.append("    Average Packet Latency (in nanoseconds): "
                           f"{avg:.3f}")
        return "\n".join(out)


    def _detailed_summary(self, t: int) -> list:
        """`iocoom_core_model.cc:64-77` outputSummary."""
        ds = self.detailed_stalls
        rows = (("Load Queue", "load_queue"), ("Store Queue", "store_queue"),
                ("L1-I Cache", "l1icache"),
                ("L1-D Cache (Intra-Instruction)", "intra_ins_l1dcache"),
                ("L1-D Cache (Inter-Instruction)", "inter_ins_l1dcache"),
                ("Execution Unit (Intra-Instruction)",
                 "intra_ins_execution_unit"),
                ("Execution Unit (Inter-Instruction)",
                 "inter_ins_execution_unit"))
        out = ["    Detailed Stall Time Breakdown (in nanoseconds): "]
        out += [f"      {label}: {ps_to_ns(int(ds[k][t]))}"
                for label, k in rows]
        return out

    def _cache_summary(self, t: int) -> list:
        """The cache counters (`cache.cc outputSummary`), with the miss
        types and the L2 line utilization when they were tracked."""
        mc = self.mem_counters
        out = ["  Cache Summary:",
               f"    L1-I Misses: {int(mc['l1i_misses'][t])}",
               "    L1-D Misses: "
               f"{int(mc['l1d_read_misses'][t] + mc['l1d_write_misses'][t])}",
               f"    L2 Misses: {int(mc['l2_misses'][t])}"]
        if int(mc["l2_cold_misses"][t] + mc["l2_capacity_misses"][t]
               + mc["l2_sharing_misses"][t]):
            out += [f"      Cold Misses: {int(mc['l2_cold_misses'][t])}",
                    "      Capacity Misses: "
                    f"{int(mc['l2_capacity_misses'][t])}",
                    "      Sharing Misses: "
                    f"{int(mc['l2_sharing_misses'][t])}"]
        hist = np.asarray(mc["line_util_hist"][t])
        if int(hist.sum()):
            out += ["    Cache Line Utilization (L2):",
                    f"      Total Reads: {int(mc['line_util_reads'][t])}",
                    f"      Total Writes: {int(mc['line_util_writes'][t])}"]
            labels = ("0", "1", "2-3", "4-7", "8-15", "16-31", "32-63",
                      ">=64")
            out += [f"      Accesses {lb}: {int(n)}"
                    for lb, n in zip(labels, hist)]
        return out


def auto_mailbox_depth(batch: TraceBatch) -> int:
    """Upper bound of the per-(dst, src) mailbox ring occupancy from the
    recorded trace (`graphite_tpu/engine/simulator.py:188`): barrier-
    phase aware when every lane waits equally often on one global
    barrier, else every send of a pair outstanding at once; at least 2,
    capped at 64 (the engine's overflow fail-stop guards the cap)."""
    op = np.asarray(batch.op)
    aux0 = np.asarray(batch.aux0)
    aux1 = np.asarray(batch.aux1)
    T, L = op.shape
    send_mask = op == int(Op.SEND)
    if L == 0 or not send_mask.any():
        return 2
    recv_mask = op == int(Op.NET_RECV)

    is_bar = (op == int(Op.BARRIER_WAIT)) | (op == int(Op.BARRIER_SYNC))
    bar_global = False
    if is_bar.any():
        bar_ids = np.unique(aux0[is_bar])
        per_lane = is_bar.sum(axis=1)
        init_mask = op == int(Op.BARRIER_INIT)
        counts = np.unique(aux1[init_mask & np.isin(aux0, bar_ids)])
        bar_global = (
            len(bar_ids) == 1
            and (per_lane == per_lane[0]).all() and per_lane[0] > 0
            and len(counts) > 0 and (counts >= T).all())
    if bar_global:
        epoch = np.cumsum(is_bar, axis=1) - is_bar   # exclusive prefix
        E = int(epoch.max()) + 1
    else:
        epoch = np.zeros((T, L), np.int64)
        E = 1
    lanes = np.broadcast_to(np.arange(T)[:, None], (T, L))

    s_src = lanes[send_mask]
    s_dst = np.clip(aux0[send_mask], 0, T - 1)
    s_e = epoch[send_mask]
    r_dst = lanes[recv_mask]
    r_src = aux0[recv_mask]                          # -1 = ANY_SENDER
    r_e = epoch[recv_mask]

    dst_sends = np.zeros((T, E), np.int64)
    np.add.at(dst_sends, (s_dst, s_e), 1)
    dst_recvs = np.zeros((T, E), np.int64)
    np.add.at(dst_recvs, (r_dst, r_e), 1)
    dst_s_cum = np.cumsum(dst_sends, axis=1)
    dst_r_cum_prev = np.concatenate(
        [np.zeros((T, 1), np.int64), np.cumsum(dst_recvs, axis=1)[:, :-1]],
        axis=1)
    dst_bound = (dst_s_cum - dst_r_cum_prev).max(axis=1)

    pair_ids = s_src.astype(np.int64) * T + s_dst
    pairs, pair_idx = np.unique(pair_ids, return_inverse=True)
    P = len(pairs)
    pair_sends = np.zeros((P, E), np.int64)
    np.add.at(pair_sends, (pair_idx, s_e), 1)
    pair_recvs = np.zeros((P, E), np.int64)
    specific = r_src >= 0
    rp_ids = r_src[specific].astype(np.int64) * T + r_dst[specific]
    rp_pos = np.searchsorted(pairs, rp_ids)
    in_range = rp_pos < P
    rp_match = np.zeros_like(rp_ids, bool)
    rp_match[in_range] = pairs[rp_pos[in_range]] == rp_ids[in_range]
    np.add.at(pair_recvs, (rp_pos[rp_match], r_e[specific][rp_match]), 1)
    pair_s_cum = np.cumsum(pair_sends, axis=1)
    pair_r_cum_prev = np.concatenate(
        [np.zeros((P, 1), np.int64), np.cumsum(pair_recvs, axis=1)[:, :-1]],
        axis=1)
    pair_bound = (pair_s_cum - pair_r_cum_prev).max(axis=1)
    bound = np.minimum(pair_bound, dst_bound[pairs % T]).max()
    return int(np.clip(bound, 2, 64))


class Simulator:
    """Builds engine parameters from a SimConfig and runs a trace batch on
    one device."""

    def __init__(
        self,
        config: "SimConfig | ConfigFile | str",
        trace: TraceBatch,
        *,
        mailbox_depth: "int | None" = None,
        inner_block: int = 32,
        bp_size: "int | None" = None,
        n_barriers: int = 64,
        n_mutexes: int = 64,
        n_conds: int = 64,
        device=None,
        stream: bool = False,
        barrier_host: "bool | None" = None,
        barrier_batch: "int | None" = None,
        telemetry=None,
        profile=None,
        hist=None,
        dvfs=None,
    ):
        """`barrier_host` and `barrier_batch` (`[general] barrier_batch`,
        default 8) are resolved and checked as in the JAX package, where
        they drive the `lax_barrier` quanta from the host in batches; the
        port's host drives every quantum already, so both leave the
        results, `n_quanta` and `last_n_iterations` as they are.  None
        resolves as there: on for `lax_barrier` with the memory subsystem
        at 1,024 tiles or more and a trace with SEND records."""
        for name, spec, item in (("telemetry", telemetry, 12),
                                 ("profile", profile, 12),
                                 ("hist", hist, 12),
                                 ("the runtime DvfsSpec (dvfs=)", dvfs, 10)):
            if spec is not None:
                raise _not_ported(name, item)
        if isinstance(config, str):
            config = ConfigFile.from_file(config)
        if isinstance(config, ConfigFile):
            config = SimConfig(config)
        self.config = config
        cfg = config.cfg
        self.trace_batch = trace
        n_tiles = trace.n_tiles
        if n_tiles != config.application_tiles:
            raise ValueError(
                f"trace has {n_tiles} tiles but config expects "
                f"{config.application_tiles} application tiles")
        mem_params = self._mem_params(config, trace)
        core_list = [config.tile_spec(t).core_type for t in range(n_tiles)]
        unknown = set(core_list) - {"iocoom", "simple", "default", "magic"}
        if unknown:
            raise NotImplementedError(f"core model(s) {sorted(unknown)!r}")
        iocoom_params, iocoom_tiles = None, None
        if "iocoom" in core_list:
            iocoom_params = IocoomParams.from_config(cfg)
            if any(t != "iocoom" for t in core_list):
                iocoom_tiles = tuple(t == "iocoom" for t in core_list)
        scheme = cfg.get_string("clock_skew_management/scheme",
                                "lax_barrier")
        self.p2p_slack_ps = None
        if scheme == "lax_barrier":
            self.quantum_ps = ns_to_ps(cfg.get_int(
                "clock_skew_management/lax_barrier/quantum", 1000))
        elif scheme == "lax_p2p":
            # unbounded quanta, the pairwise hold applied inside the step
            self.quantum_ps = None
            self.p2p_slack_ps = ns_to_ps(cfg.get_int(
                "clock_skew_management/lax_p2p/slack", 1000))
        else:
            self.quantum_ps = None  # lax: one unbounded quantum
        # host-driven lax_barrier quanta (`engine/simulator.py:648-678` of
        # the JAX package): the default, its checks and its batch size
        if barrier_host is None:
            barrier_host = (self.quantum_ps is not None
                            and mem_params is not None
                            and n_tiles >= 1024
                            and bool(np.any(trace.op == int(Op.SEND)))
                            and not stream)
        if barrier_host and self.quantum_ps is None:
            raise ValueError(
                "barrier_host=True needs the lax_barrier clock scheme "
                "(there are no quanta to drive host-side otherwise)")
        self.barrier_host = bool(barrier_host)
        if self.barrier_host and stream:
            raise ValueError(
                "host-driven lax_barrier quanta support single-device "
                "resident runs only")
        if barrier_batch is None:
            barrier_batch = cfg.get_int("general/barrier_batch", 8)
        if barrier_batch < 1:
            raise ValueError("barrier_batch must be >= 1")
        self.barrier_batch = int(barrier_batch)
        if stream:
            raise _not_ported("trace streaming (stream=True)", 11)
        net_params = UserNetworkParams.from_config(config)
        # the USER net's contention model (`engine/simulator.py:561-571`
        # of the JAX package); the mailbox then takes its routed latency
        user_hbh = user_atac = None
        if config.network_types[0] == "emesh_hop_by_hop":
            user_hbh = HopByHopParams.from_config(config, "user")
        elif config.network_types[0] == "atac":
            user_atac = AtacParams.from_config(config, "user")
        if user_hbh is not None or user_atac is not None:
            net_params = UserNetworkParams(kind="routed",
                                           freq_mhz=net_params.freq_mhz)

        if mailbox_depth is None:
            mailbox_depth = auto_mailbox_depth(trace)
        costs = tuple(cfg.get_int(f"core/static_instruction_costs/{k}", 0)
                      for k in STATIC_COST_KEYS)
        bp_type = cfg.get_string("branch_predictor/type", "one_bit")
        dvfs_params = DvfsParams.from_config(cfg)
        present_ops = np.unique(np.asarray(trace.op))
        self.params = EngineParams(
            n_tiles=n_tiles,
            static_cost_cycles=costs,
            net=net_params,
            bp_enabled=(bp_type != "none"),
            bp_size=bp_size or cfg.get_int("branch_predictor/size", 1024),
            bp_mispredict_penalty=cfg.get_int(
                "branch_predictor/mispredict_penalty", 14),
            mailbox_depth=mailbox_depth,
            inner_block=inner_block,
            n_conds=n_conds,
            # SYSTEM network: always magic, 1 cycle each way at 1 GHz
            syscall_rt_ps=int(cycles_to_ps(2, 1000)),
            dvfs=dvfs_params,
            plain_unroll=self._resolve_plain_unroll(
                cfg, mem_params is None and iocoom_params is None),
            units=units_for_ops(present_ops),
            mem=mem_params,
            iocoom=iocoom_params,
            iocoom_tiles=iocoom_tiles,
            user_hbh=user_hbh,
            user_atac=user_atac,
            p2p_slack_ps=self.p2p_slack_ps,
        )

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            check_card_limits(self.params, n_barriers)
        models_on = not cfg.get_bool(
            "general/trigger_models_within_application", False)
        state = init_state(
            n_tiles,
            core_freq_mhz=module_freq_mhz(cfg, "CORE"),
            device=self.device,
            bp_size=self.params.bp_size,
            mailbox_depth=mailbox_depth,
            n_barriers=n_barriers,
            n_mutexes=n_mutexes,
            n_conds=n_conds,
            models_enabled=models_on,
        )
        nd = dvfs_params.n_domains
        freqs = torch.tensor(dvfs_params.domain_freq_mhz, dtype=torch.int32,
                             device=self.device)
        volts = torch.tensor(
            [dvfs_params.min_voltage_mv(f)
             for f in dvfs_params.domain_freq_mhz],
            dtype=torch.int32, device=self.device)
        state.dvfs = DvfsState(
            freq_mhz=freqs[None, :].expand(n_tiles, nd).contiguous(),
            voltage_mv=volts[None, :].expand(n_tiles, nd).contiguous(),
            errors=torch.zeros(n_tiles, dtype=torch.int64,
                               device=self.device),
        )
        if user_hbh is not None:
            state.noc_user = init_noc_state(user_hbh, self.device)
        elif user_atac is not None:
            state.noc_user = init_atac_state(user_atac, self.device)
        models = ModelCtx()
        if mem_params is not None:
            state.mem = (init_shl2_state if mem_params.is_shl2
                         else init_mem_state)(mem_params, self.device)
            models.mem = MemCtx(mem_params, self.device)
        if iocoom_params is not None:
            state.ioc = init_iocoom_state(n_tiles, iocoom_params,
                                          self.device)
            models.ioc_tile = torch.tensor(
                iocoom_tiles or (True,) * n_tiles, dtype=torch.bool,
                device=self.device)
        self.models = models
        self.state: SimState = state
        self.device_trace = DeviceTrace.from_batch(
            trace, self.device, addrs=mem_params is not None,
            regs=iocoom_params is not None)
        self._cost_table = cost_table_tensor(self.params, self.device)
        self._lanes = Lanes.zeros(n_tiles, self.device)
        # subquantum iterations executed by the last run
        self.last_n_iterations = 0

    @staticmethod
    def _mem_params(config: SimConfig, trace: TraceBatch):
        """The memory subsystem's parameters, or None when shared memory
        is off or the trace touches no memory (`engine/simulator.py:
        447-472` of the JAX package); raises for what is not ported."""
        cfg = config.cfg
        has_mem = bool(
            np.any(trace.flags & (FLAG_MEM0_VALID | FLAG_MEM1_VALID))
        ) or cfg.get_bool("general/enable_icache_modeling", False)
        dyn_mem = np.any(
            (trace.op >= 15) & (trace.op < 20)
            & ((trace.flags & (FLAG_MEM0_VALID | FLAG_MEM1_VALID)) != 0))
        if bool(dyn_mem):
            raise ValueError(
                "dynamic trace records (ops 15-19) must not carry "
                "FLAG_MEM*_VALID memory operands")
        if not (config.enable_shared_mem and has_mem):
            return None
        protocol = cfg.get_string("caching_protocol/type",
                                  "pr_l1_pr_l2_dram_directory_msi")
        if protocol not in ("pr_l1_pr_l2_dram_directory_msi",
                            "pr_l1_pr_l2_dram_directory_mosi",
                            "pr_l1_sh_l2_msi", "pr_l1_sh_l2_mesi"):
            raise NotImplementedError(
                f"caching protocol {protocol!r} pending")
        return MemParams.from_config(config)

    @staticmethod
    def _resolve_plain_unroll(cfg, memoryless: bool) -> int:
        pu = cfg.get_int("general/plain_unroll", 16 if memoryless else 1)
        if pu > PLAIN_UNROLL_MAX:
            warnings.warn(
                f"[general] plain_unroll = {pu} exceeds the ceiling "
                f"{PLAIN_UNROLL_MAX}; clamping to {PLAIN_UNROLL_MAX}",
                stacklevel=3)
            pu = PLAIN_UNROLL_MAX
        return pu

    def _drive(self, max_quanta: int):
        """Quanta until done, an error or `max_quanta`; returns (quanta,
        all done).  The host drives every quantum, so `barrier_host`'s
        batches (`engine/simulator.py:1262-1303` of the JAX package) reach
        the same state in one call; `barrier_batch` changes nothing."""
        n, deadlock, iters = run_simulation(
            self.params, self.device_trace, self.state, self.quantum_ps,
            max_quanta, self._lanes, self._cost_table, self.models)
        self.last_n_iterations = iters
        overflow = bool(self.state.net.overflow.item())
        done = self.state.done.cpu().numpy()
        if overflow:
            raise MailboxOverflowError(
                "a (dst,src) mailbox ring overflowed; re-run with a "
                "larger mailbox_depth")
        if deadlock:
            blocked = np.flatnonzero(~done).tolist()
            raise DeadlockError(
                f"no progress across a quantum; blocked tiles: "
                f"{blocked[:16]}{'...' if len(blocked) > 16 else ''}")
        if self.barrier_host and n == 0 and max_quanta > 0 and not done.all():
            # the loop's entry condition makes this unreachable
            raise DeadlockError(
                "host-barrier batch made no progress and raised no flag")
        return n, bool(done.all())

    def run_chunk(self, n_quanta: int):
        """Run at most `n_quanta` quanta; returns (all done, quanta run).
        Reaching the bound is not an error."""
        n, all_done = self._drive(n_quanta)
        return all_done, n

    def run(self, max_quanta: int = 1_000_000) -> SimResults:
        """Drive quanta until every tile's trace is exhausted."""
        n, all_done = self._drive(max_quanta)
        if not all_done:
            raise RuntimeError(f"exceeded max_quanta={max_quanta}")
        return self.results(n)

    def warmup(self, max_quanta: int = 1_000_000) -> None:
        """Build the kernels and execute the whole run once on a copy of
        the state, discarding the result, so a timed `run()` that follows
        excludes the build and first-launch costs."""
        if self.device.type == "cuda":
            from graphite_tpu_torch.ops.build import build_all

            build_all()
        saved, saved_iters = self.state, self.last_n_iterations
        self.state = saved.clone()
        try:
            self._drive(max_quanta)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.state, self.last_n_iterations = saved, saved_iters

    def run_streamed(self, *args, **kwargs):
        raise _not_ported("trace streaming (run_streamed)", 11)

    def write_output(self, results: SimResults,
                     output_dir: str = "results") -> str:
        """Write `sim.out` (the summary) and the sorted config snapshot
        `carbon_sim.cfg` into `output_dir`, byte for byte as the JAX
        package does (`engine/simulator.py:1396-1410`); returns the path
        of `sim.out`."""
        import os

        os.makedirs(output_dir, exist_ok=True)
        out_path = os.path.join(output_dir, "sim.out")
        with open(out_path, "w") as f:
            f.write(results.summary() + "\n")
        with open(os.path.join(output_dir, "carbon_sim.cfg"), "w") as f:
            for key, value in sorted(self.config.cfg.as_dict().items()):
                f.write(f"{key} = {value}\n")
        return out_path

    def results(self, n_quanta: int) -> SimResults:
        """SimResults from the current state."""
        core = self.state.core
        net = self.state.net

        def h(t):
            return t.cpu().numpy()

        clock = h(core.clock_ps)
        mem, ioc = self.state.mem, self.state.ioc
        return SimResults(
            n_tiles=self.params.n_tiles,
            completion_time_ps=int(clock.max()),
            instruction_count=h(core.instruction_count),
            clock_ps=clock,
            memory_stall_ps=h(core.memory_stall_ps),
            execution_stall_ps=h(core.execution_stall_ps),
            recv_instructions=h(core.recv_instructions),
            recv_stall_ps=h(core.recv_stall_ps),
            sync_instructions=h(core.sync_instructions),
            sync_stall_ps=h(core.sync_stall_ps),
            bp_correct=h(core.bp_correct),
            bp_incorrect=h(core.bp_incorrect),
            packets_sent=h(net.packets_sent),
            packets_received=h(net.packets_received),
            total_packet_latency_ps=h(net.total_latency_ps),
            n_quanta=int(n_quanta),
            mem_counters=(None if mem is None else {
                n: h(getattr(mem.counters, n)) for n in COUNTER_NAMES}),
            func_errors=0 if mem is None else int(mem.func_errors),
            detailed_stalls=None if ioc is None else ioc.detailed_stalls(),
        )

    def line_census(self, lines) -> dict:
        """The per-line coherence view of the current memory state
        (`memory/engine.py` line_census, or `memory/engine_shl2.py`
        shl2_line_census under a shared-L2 protocol)."""
        census = (shl2_line_census if self.params.mem.is_shl2
                  else line_census)
        return census(self.state.mem, self.params.mem, lines)

    @property
    def last_phase_skips(self) -> "dict | None":
        """The shared-L2 engine's per-phase skip counts so far (phase
        name -> count, `mem_phase_names` order; counted on the CPU path
        only), or None for a run without that engine (the port keeps no
        skip counts for the private-L2 engine)."""
        skips = getattr(self.state.mem, "phase_skips", None)
        if skips is None:
            return None
        names = mem_phase_names(self.params)
        return {n: int(v) for n, v in zip(names, skips.tolist())}

"""`iocoom_commit`: one committing record per lane through the IOCOOM
pipeline algebra.

Replaces `iocoom_commit` (`graphite_tpu/models/iocoom.py:129-330`) and
the heterogeneous `iocoom_tiles` mask of the step (`graphite_tpu/engine/
step.py:856-900`).  Kernel: `csrc/iocoom_commit.cu`, one thread a lane,
launched through a binding (`build.Kernel.launch_bound`).

A lane commits here when it is an iocoom tile, active, at an
instruction record (static or branch) whose memory slots are complete,
and models are enabled (the step's `advance & instr_like & ioc_tiles`,
which for such a record is `active & mem_ok`).  Per committing lane:
instruction fetch (icache latency less one cycle), the register
operands on the scoreboard split by producing unit, the loads through
the store-queue bypass or the load-queue ring, the execution, the write
register stamped, the stores through the store-queue ring ordered after
the last load, then the clock advance and the seven stall counters.
Outputs: `lanes.ioc_clock` (the committing lanes' new clock, else the
old one) and `lanes.ioc_mem_stall` / `lanes.ioc_exec_stall` (0 where
not committing), which `lane_commit` applies.
"""

from __future__ import annotations

import torch

from graphite_tpu_torch.models.iocoom import (
    NUM_REGISTERS, UNIT_EXEC, UNIT_LOAD, IocoomParams, IocoomState,
)
from graphite_tpu_torch.ops.build import Kernel, pack_args
from graphite_tpu_torch.time_types import cycles_to_ps
from graphite_tpu_torch.trace.schema import (
    FLAG_MEM0_VALID, FLAG_MEM0_WRITE, FLAG_MEM1_VALID, FLAG_MEM1_WRITE,
    FLAG_SIMPLE_MOV_LOAD, NO_REG, Op,
)


_STALLS = tuple(f"{n}_stall_ps" for n in (
    "load_queue", "store_queue", "l1icache", "intra_ins_l1dcache",
    "inter_ins_l1dcache", "intra_ins_execution_unit",
    "inter_ins_execution_unit"))


def _pack(tensors: tuple, key: tuple):
    """Validate and pack one argument set (`IocArgs` in
    csrc/iocoom_commit.cu: the pointers, then T, L, LQ, SQ and the two
    queue options; the addresses and slot latencies are null without a
    memory subsystem)."""
    p, L = key
    T = tensors[0].shape[0]
    LQ, SQ = p.num_load_queue_entries, p.num_store_queue_entries
    i64, i32, b = torch.int64, torch.int32, torch.bool
    t = (T,)
    specs = [("lanes.op", i32, t), ("lanes.flags", i32, t),
             ("lanes.active", b, t), ("lanes.cost_ps", i64, t),
             ("lanes.mem_ok", b, t), ("lanes.ioc_clock", i64, t),
             ("lanes.ioc_mem_stall", i64, t),
             ("lanes.ioc_exec_stall", i64, t), ("ioc_tile", b, t),
             ("core.idx", i32, t), ("core.clock_ps", i64, t),
             ("core.freq_mhz", i32, t), ("trace.rreg0", i32, (T, L)),
             ("trace.rreg1", i32, (T, L)), ("trace.wreg", i32, (T, L)),
             ("trace.addr0", i64, (T, L)), ("trace.addr1", i64, (T, L)),
             ("slot_lat", i64, (T, 3)), ("enabled", b, ()),
             ("ioc.reg_ready_ps", i64, (T, NUM_REGISTERS)),
             ("ioc.reg_unit", torch.uint8, (T, NUM_REGISTERS)),
             ("ioc.lq_dealloc_ps", i64, (T, LQ)), ("ioc.lq_idx", i32, t),
             ("ioc.sq_dealloc_ps", i64, (T, SQ)),
             ("ioc.sq_addr", i32, (T, SQ)), ("ioc.sq_idx", i32, t)]
    specs += [(f"ioc.{n}", i64, t) for n in _STALLS]
    return pack_args(tensors, specs, (
        T, L, LQ, SQ, int(p.speculative_loads_enabled),
        int(p.multiple_outstanding_rfos_enabled)))


KERNEL = Kernel("iocoom_commit", "gt_iocoom_commit", pack=_pack)


def bound_args(p: IocoomParams, ioc: IocoomState, lanes, ioc_tile, core,
               trace, slot_lat, enabled) -> tuple:
    """The (tensors, key) a call binds, in `IocArgs` order."""
    mem = slot_lat is not None
    return ((lanes.op, lanes.flags, lanes.active, lanes.cost_ps,
             lanes.mem_ok, lanes.ioc_clock, lanes.ioc_mem_stall,
             lanes.ioc_exec_stall, ioc_tile, core.idx, core.clock_ps,
             core.freq_mhz, trace.rreg0, trace.rreg1, trace.wreg,
             trace.addr0 if mem else None, trace.addr1 if mem else None,
             slot_lat, enabled, ioc.reg_ready_ps, ioc.reg_unit,
             ioc.lq_dealloc_ps, ioc.lq_idx, ioc.sq_dealloc_ps, ioc.sq_addr,
             ioc.sq_idx, *(getattr(ioc, n) for n in _STALLS)),
            (p, trace.rreg0.shape[1]))


def _at(arr, idx):
    return torch.gather(arr, 1, idx.to(torch.int64)[:, None])[:, 0]


def _put(arr, idx, val, mask) -> None:
    rows = torch.arange(arr.shape[0], device=arr.device)
    idx = idx.to(torch.int64)
    arr[rows, idx] = torch.where(mask, val.to(arr.dtype), arr[rows, idx])


def iocoom_commit_plain(p: IocoomParams, ioc: IocoomState, lanes, ioc_tile,
                        clock, freq_mhz, regs, addrs, slot_lat,
                        enabled) -> None:
    """`regs` = (rreg0, rreg1, wreg) and `addrs` = (addr0, addr1) of each
    lane's record ([T] each, addresses zero-extended), `slot_lat` the
    per-slot memory latencies int64[T, 3]."""
    op = lanes.op
    instr_like = op < Op.DYNAMIC_MISC
    commit = (lanes.active & instr_like & lanes.mem_ok & ioc_tile
              & enabled)
    f = freq_mhz.to(torch.int64)
    one = cycles_to_ps(torch.ones_like(f), f)
    flags = lanes.flags

    icache_lat = slot_lat[:, 0]
    icache_lat = torch.where(icache_lat >= one, icache_lat - one, icache_lat)
    instruction_ready = clock + icache_lat

    def reg_read(r):
        valid = r != NO_REG
        rr = torch.clamp(r, 0, NUM_REGISTERS - 1)
        ready = _at(ioc.reg_ready_ps, rr)
        unit = _at(ioc.reg_unit, rr)
        return (torch.where(valid & (unit == UNIT_LOAD), ready, 0),
                torch.where(valid & (unit == UNIT_EXEC), ready, 0))

    rreg0, rreg1, wreg = regs
    l0, e0 = reg_read(rreg0)
    l1, e1 = reg_read(rreg1)
    ready_load = torch.maximum(instruction_ready, torch.maximum(l0, l1))
    ready_exec = torch.maximum(instruction_ready, torch.maximum(e0, e1))
    reg_ops_ready = torch.maximum(ready_load, ready_exec)

    m0v = (flags & FLAG_MEM0_VALID) != 0
    m1v = (flags & FLAG_MEM1_VALID) != 0
    m0w = (flags & FLAG_MEM0_WRITE) != 0
    m1w = (flags & FLAG_MEM1_WRITE) != 0
    smov = (flags & FLAG_SIMPLE_MOV_LOAD) != 0
    lines = [(a >> 6).to(torch.int32) for a in addrs]

    lq, LQ = ioc.lq_dealloc_ps, ioc.lq_dealloc_ps.shape[1]
    lq_ready = reg_ops_ready
    mem_ready = reg_ops_ready
    for line, lat, is_load in ((lines[0], slot_lat[:, 1], commit & m0v & ~m0w),
                               (lines[1], slot_lat[:, 2], commit & m1v & ~m1w)):
        sched = reg_ops_ready
        byp = ((ioc.sq_addr == line[:, None])
               & (ioc.sq_dealloc_ps >= sched[:, None])).any(dim=1)
        use_lq = is_load & ~byp
        load_lat = lat + one
        head = _at(lq, torch.remainder(ioc.lq_idx, LQ))
        last = _at(lq, torch.remainder(ioc.lq_idx + LQ - 1, LQ))
        alloc = torch.maximum(head, sched)
        if p.speculative_loads_enabled:
            completion = alloc + load_lat
            dealloc = torch.maximum(completion, last + one)
        else:
            completion = torch.maximum(last, sched) + load_lat
            dealloc = completion
        _put(lq, torch.remainder(ioc.lq_idx, LQ), dealloc, use_lq)
        ioc.lq_idx.add_(use_lq.to(torch.int32))
        alloc = torch.where(byp, sched, alloc)
        completion = torch.where(byp, sched + one, completion)
        lq_ready = torch.where(is_load, torch.maximum(lq_ready, alloc),
                               lq_ready)
        mem_ready = torch.where(is_load, torch.maximum(mem_ready, completion),
                                mem_ready)

    read_ops_ready = mem_ready
    write_ops_ready = read_ops_ready + lanes.cost_ps
    w_valid = commit & (wreg != NO_REG)
    wr = torch.clamp(wreg, 0, NUM_REGISTERS - 1)
    _put(ioc.reg_ready_ps, wr, write_ops_ready, w_valid)
    _put(ioc.reg_unit, wr, torch.where(smov, UNIT_LOAD, UNIT_EXEC), w_valid)

    sq, SQ = ioc.sq_dealloc_ps, ioc.sq_dealloc_ps.shape[1]
    last_load_dealloc = _at(lq, torch.remainder(ioc.lq_idx + LQ - 1, LQ))
    sq_ready = write_ops_ready
    for line, lat, is_store in ((lines[0], slot_lat[:, 1], commit & m0v & m0w),
                                (lines[1], slot_lat[:, 2], commit & m1v & m1w)):
        sched = write_ops_ready
        store_lat = lat + one
        head = _at(sq, torch.remainder(ioc.sq_idx, SQ))
        last = _at(sq, torch.remainder(ioc.sq_idx + SQ - 1, SQ))
        alloc = torch.maximum(head, sched)
        if p.multiple_outstanding_rfos_enabled:
            completion = alloc + store_lat
            dealloc = torch.maximum(torch.maximum(completion, last + one),
                                    last_load_dealloc)
        else:
            issue = torch.maximum(torch.maximum(sched, last),
                                  last_load_dealloc)
            dealloc = issue + store_lat
        pos = torch.remainder(ioc.sq_idx, SQ)
        _put(sq, pos, dealloc, is_store)
        _put(ioc.sq_addr, pos, line, is_store)
        ioc.sq_idx.add_(is_store.to(torch.int32))
        sq_ready = torch.where(is_store, torch.maximum(sq_ready, alloc),
                               sq_ready)

    has_write_mem = (m0w & m0v) | (m1w & m1v)
    wm = ~smov & has_write_mem
    new_clock = torch.where(~smov, read_ops_ready, lq_ready)
    new_clock = torch.where(wm, sq_ready, new_clock)
    stalls = {
        "l1icache": instruction_ready - clock,
        "inter_ins_execution_unit": ready_exec - instruction_ready,
        "inter_ins_l1dcache": reg_ops_ready - ready_exec,
        "load_queue": lq_ready - reg_ops_ready,
        "intra_ins_l1dcache": torch.where(~smov, mem_ready - lq_ready, 0),
        "intra_ins_execution_unit": torch.where(
            wm, write_ops_ready - read_ops_ready, 0),
        "store_queue": torch.where(wm, sq_ready - write_ops_ready, 0),
    }
    for name, v in stalls.items():
        getattr(ioc, f"{name}_stall_ps").add_(torch.where(commit, v, 0))
    mem_stall = (stalls["l1icache"] + stalls["inter_ins_l1dcache"]
                 + stalls["load_queue"] + stalls["intra_ins_l1dcache"]
                 + stalls["store_queue"])
    exec_stall = (stalls["inter_ins_execution_unit"]
                  + stalls["intra_ins_execution_unit"])
    lanes.ioc_clock.copy_(torch.where(commit, new_clock, clock))
    lanes.ioc_mem_stall.copy_(torch.where(commit, mem_stall, 0))
    lanes.ioc_exec_stall.copy_(torch.where(commit, exec_stall, 0))


def iocoom_inputs(core, trace, slot_lat):
    """The plain version's per-lane inputs: (regs, addrs, slot_lat) of
    each lane's record; without a memory subsystem (`slot_lat` None) the
    addresses and latencies are 0, as in the JAX step."""
    T = core.clock_ps.shape[0]
    dev = core.clock_ps.device
    col = torch.clamp(core.idx, max=trace.length - 1).to(
        torch.int64)[:, None]

    def at(c):
        return torch.gather(c, 1, col)[:, 0]

    regs = tuple(at(c) for c in (trace.rreg0, trace.rreg1, trace.wreg))
    if slot_lat is None:
        z = torch.zeros(T, dtype=torch.int64, device=dev)
        return regs, (z, z), torch.zeros((T, 3), dtype=torch.int64,
                                         device=dev)
    return regs, (at(trace.addr0), at(trace.addr1)), slot_lat


def iocoom_commit(p: IocoomParams, ioc: IocoomState, lanes, ioc_tile, core,
                  trace, slot_lat, enabled) -> None:
    """The iocoom commit of one iteration in place on `ioc`, into the
    `lanes` iocoom outputs.  `slot_lat` is the memory engine's per-slot
    latencies (None without a memory subsystem)."""
    dev = core.clock_ps.device
    if dev.type == "cpu":
        regs, addrs, lat = iocoom_inputs(core, trace, slot_lat)
        iocoom_commit_plain(p, ioc, lanes, ioc_tile, core.clock_ps,
                            core.freq_mhz, regs, addrs, lat, enabled)
        return
    if dev.type != "cuda":
        raise ValueError(f"iocoom_commit: unsupported device {dev}")
    KERNEL.launch_bound(*bound_args(p, ioc, lanes, ioc_tile, core, trace,
                                    slot_lat, enabled))

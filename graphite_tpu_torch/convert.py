"""numpy <-> port conversions: carry a JAX run's trace and state across.

The analog of converting a checkpoint's weights between frameworks.  The
functions speak plain numpy, so this package still imports nothing of
JAX:

 - `trace_from_arrays({field: ndarray})` builds the port's `TraceBatch`
   from the numpy fields of any TraceBatch (the JAX package's, a loaded
   `.npz`, or a dict);
 - `state_from_arrays(tree, device)` builds the port's `SimState` from a
   `jax.device_get` of a JAX `SimState` — any object or mapping with the
   same field names and numpy leaves — memory (`MemState`, the private-
   L2 engine's, or `ShL2State`, the shared-L2 engine's, with the MEMORY
   net's queues `noc`), iocoom
   (`IocoomState`) and the USER net's contention queues (`noc_user`:
   hop-by-hop `NocState` or ATAC `AtacState`) included;
 - `state_to_arrays(state)` is the inverse: a nested dict of numpy arrays
   with the JAX leaves' names, dtypes and shapes;
 - `checkpoint_arrays(state)` / `state_from_checkpoint(arrays, device)`
   speak the JAX checkpoint's flat layout (`graphite_tpu/system/
   checkpoint.py:20-29`): one array per leaf, keyed by its pytree path
   ("core||clock_ps", "mem||l2||meta", ...), absent leaves left out,
   the uint32 leaves as uint32.  Keys are field names, so nothing here
   needs JAX.

A JAX run can thus be handed to the port mid-run (`Simulator.state =
state_from_arrays(...)`, or a JAX checkpoint through
`system.load_checkpoint`) and continued on the card.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from graphite_tpu_torch.engine.state import (
    CoreState, DvfsState, SimState, SyncState, UserNetState,
)
from graphite_tpu_torch.memory.state import (
    FAR, MSG_NONE, PHASE_IDLE, CacheArrays, DirectoryArrays, MemCounters,
    MemMailboxes, MemState, RequesterState, ShL2Dir, ShL2State, ShL2Txn,
    TxnState,
)
from graphite_tpu_torch.models.iocoom import IocoomState
from graphite_tpu_torch.models.network_atac import AtacState
from graphite_tpu_torch.models.network_hop_by_hop import NocState
from graphite_tpu_torch.models.queue_models import QueueArrays
from graphite_tpu_torch.trace.schema import _FIELDS, TraceBatch

# SimState leaves of subsystems this package has not ported, with the
# ROADMAP.md queue-1 item that ports each
_UNPORTED = {
    "telemetry": 12, "profile": 12, "dvfs_rt": 10, "hist": 12,
}
# uint32 words the port holds as int32 bit patterns (memory/state.py); the
# other uint32 leaves (miss types, line utilization, the functional
# store) become int64
_INT32_WORDS = ("sharers", "pending")
# the uint32 leaves the port holds zero-extended as int64
_UINT32_WIDE = ("func_mem", "l2_util", "mt")
# the separator of a checkpoint key's path (`graphite_tpu/system/
# checkpoint.py` _SEP)
CKPT_SEP = "||"


def _get(tree, name, default=None):
    if isinstance(tree, Mapping):
        return tree.get(name, default)
    return getattr(tree, name, default)


# (dataclass, field) -> the dataclass of a nested node
_SUBTREES = {
    ("MemState", "l1i"): CacheArrays, ("MemState", "l1d"): CacheArrays,
    ("MemState", "l2"): CacheArrays,
    ("MemState", "directory"): DirectoryArrays,
    ("MemState", "txn"): TxnState, ("MemState", "mail"): MemMailboxes,
    ("MemState", "req"): RequesterState,
    ("MemState", "counters"): MemCounters,
    ("NocState", "queues"): QueueArrays,
    ("AtacState", "hub_queues"): QueueArrays,
    ("MemState", "noc"): "noc",
    ("ShL2State", "l1i"): CacheArrays, ("ShL2State", "l1d"): CacheArrays,
    ("ShL2State", "l2"): CacheArrays, ("ShL2State", "dir"): ShL2Dir,
    ("ShL2State", "txn"): ShL2Txn, ("ShL2State", "mail"): MemMailboxes,
    ("ShL2State", "req"): RequesterState,
    ("ShL2State", "counters"): MemCounters,
    ("ShL2State", "noc"): "noc",
}


def trace_from_arrays(arrays) -> TraceBatch:
    """A port TraceBatch from a mapping (or object) of numpy trace fields;
    each field is cast to the schema's dtype."""
    out = {}
    for name, dtype in _FIELDS:
        a = _get(arrays, name)
        if a is None:
            raise KeyError(f"trace field {name!r} missing")
        out[name] = np.asarray(a).astype(dtype, copy=True)
    shapes = {a.shape for a in out.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError(f"trace fields must share one [T, L] shape, "
                         f"got {sorted(shapes)}")
    return TraceBatch(**out)


def _leaf(a, device, name="") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        # the port keeps no uint32 tensors (engine/state.py, memory/state.py)
        a = a.view(np.int32) if name in _INT32_WORDS else a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _node(cls, tree, device, optional=()):
    """`cls` from the same-named leaves (or sub-dataclasses) of `tree`."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = _get(tree, f.name)
        if v is None:
            if f.name in optional:
                kwargs[f.name] = None
                continue
            raise KeyError(f"{cls.__name__}.{f.name} missing")
        sub = _SUBTREES.get((cls.__name__, f.name))
        if sub == "noc":
            kwargs[f.name] = noc_state_from_arrays(v, device)
        else:
            kwargs[f.name] = (_node(sub, v, device) if sub is not None
                              else _leaf(v, device, f.name))
    return cls(**kwargs)


def mem_state_from_arrays(tree, device):
    """The port's MemState (from a JAX MemState's numpy leaves, the
    private-L2 engine's) or ShL2State (from a JAX ShL2State's, the
    shared-L2 engine's: it has `dir`), the MEMORY net's contention queues
    (`noc`) included.  The JAX-only `live` is dropped, and the private
    engine's `phase_skips` too (the port counts the shared-L2 engine's
    only); staged directory writes must have been flushed (the port
    writes the directory in place)."""
    if _get(tree, "dir") is not None:
        return _node(ShL2State, tree, device, optional=("noc",))
    d = _get(tree, "directory")
    skey = _get(d, "skey")
    if skey is not None and bool(np.any(np.asarray(skey) >= 0)):
        raise ValueError("the JAX state holds staged directory writes: "
                         "flush them (dir_stage_flush) before converting")
    return _node(MemState, tree, device, optional=("l2_util", "mt", "noc"))


def noc_state_from_arrays(tree, device):
    """A contention net's queues (the USER net's `noc_user`, the MEMORY
    net's `MemState.noc`): a hop-by-hop `NocState` (leaf `queues`) or an
    ATAC `AtacState` (leaf `hub_queues`)."""
    if _get(tree, "queues") is not None:
        return _node(NocState, tree, device)
    return _node(AtacState, tree, device)


def state_from_arrays(tree, device) -> SimState:
    """The port's SimState from a JAX SimState's numpy leaves."""
    for name, item in _UNPORTED.items():
        if _get(tree, name) is not None:
            raise NotImplementedError(
                f"SimState.{name} belongs to a subsystem not ported yet "
                f"(ROADMAP.md queue 1, item {item})")
    dvfs = _get(tree, "dvfs")
    p2p = _get(tree, "p2p_round")
    mem = _get(tree, "mem")
    ioc = _get(tree, "ioc")
    noc = _get(tree, "noc_user")
    return SimState(
        core=_node(CoreState, _get(tree, "core"), device),
        net=_node(UserNetState, _get(tree, "net"), device),
        sync=_node(SyncState, _get(tree, "sync"), device),
        models_enabled=_leaf(_get(tree, "models_enabled"), device),
        done=_leaf(_get(tree, "done"), device),
        dvfs=None if dvfs is None else _node(DvfsState, dvfs, device),
        p2p_round=None if p2p is None else _leaf(p2p, device),
        mem=None if mem is None else mem_state_from_arrays(mem, device),
        ioc=None if ioc is None else _node(IocoomState, ioc, device),
        noc_user=None if noc is None else noc_state_from_arrays(noc, device),
    )


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: _to_np(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def state_to_arrays(state: SimState) -> dict:
    """A nested dict of numpy arrays, one entry per SimState leaf, named
    like the JAX package's pytree (None for absent optional nodes)."""
    return _to_np(state)


def _checkpoint_leaves(tree, prefix: str = ""):
    """(key, field name, tensor) of every present leaf, in field order."""
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        key = f"{prefix}{CKPT_SEP}{f.name}" if prefix else f.name
        if isinstance(v, torch.Tensor):
            yield key, f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _checkpoint_leaves(v, key)


def _jax_dtype(name: str, t: torch.Tensor) -> np.dtype:
    if name in _INT32_WORDS or name in _UINT32_WIDE:
        return np.dtype(np.uint32)
    return np.dtype(str(t.dtype).removeprefix("torch."))


def checkpoint_layout(state: SimState) -> dict:
    """{pytree path: (shape, JAX dtype)} of the leaves `state` has."""
    return {key: (tuple(t.shape), _jax_dtype(name, t))
            for key, name, t in _checkpoint_leaves(state)}


def checkpoint_arrays(state: SimState) -> dict:
    """The JAX checkpoint's arrays of `state`: {pytree path: array}, with
    the JAX leaves' dtypes.  Two leaves only the JAX package has are
    added so that it can load the file: `mem||live` (any protocol state
    outstanding, `memory/engine.py` protocol_live) and the per-phase skip
    counters `mem||phase_skips` (zeros).  A JAX run with directory
    staging has leaves the port has no counterpart for, and cannot load
    it."""
    out = {}
    for key, name, t in _checkpoint_leaves(state):
        a = t.detach().cpu().numpy()
        if name in _INT32_WORDS:
            a = a.view(np.uint32)
        elif name in _UINT32_WIDE:
            a = a.astype(np.uint32)
        out[key] = a
    if state.mem is not None:
        ms = state.mem
        mail = ms.mail
        live = (any(bool((getattr(mail, f) != MSG_NONE).any()) for f in (
            "req_type", "evict_type", "fwd_type", "ack_type", "rep_type"))
            or bool(ms.txn.active.any()) or bool(ms.txn.saved_valid.any())
            or bool((ms.req.phase != PHASE_IDLE).any()))
        if isinstance(ms, ShL2State):
            # the shared-L2 engine's in-flight DRAM fetches
            live = live or bool((ms.txn.dram_ready_ps < FAR).any())
        out[f"mem{CKPT_SEP}live"] = np.asarray(live)
        out.setdefault(f"mem{CKPT_SEP}phase_skips", np.zeros(6, np.int64))
    return out


def state_from_checkpoint(arrays, device) -> SimState:
    """The port's SimState from a JAX checkpoint's arrays (a mapping of
    pytree path -> array, such as an open `np.load` of one); keys that
    start with `__` (the quantum counter) are skipped."""
    tree: dict = {}
    for key in arrays.keys():
        if key.startswith("__"):
            continue
        *path, leaf = key.split(CKPT_SEP)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arrays[key])
    return state_from_arrays(tree, device)

"""Memory-subsystem parameters resolved from the config (host only).

A copy of `graphite_tpu/memory/params.py` for the port (which imports
nothing of the JAX package): cache geometries from `[l1_icache/<type>]`,
`[l1_dcache/<type>]`, `[l2_cache/<type>]` with per-tile padding for
heterogeneous `[tile] model_list` geometries, directory auto-sizing
(`cache/directory_cache.cc:244-330`), DRAM timing, memory-controller
placement, the DVFS synchronization delays, and the MEMORY network: the
zero-load hop counter or magic, or a contention model that every
coherence message routes through (`net_hbh` under emesh_hop_by_hop,
`net_atac` under atac).
"""

from __future__ import annotations

import dataclasses
import math

from graphite_tpu_torch.config.simconfig import SimConfig
from graphite_tpu_torch.models.network_emesh import mesh_dims

# ShmemMsg modeled lengths (`memory_subsystem/shmem_msg.h:8`,
# `pr_l1_pr_l2_dram_directory_msi/shmem_msg.h:81`, `shmem_msg.cc:100-125`).
NUM_MSG_TYPE_BITS = 4
NUM_PHYSICAL_ADDRESS_BITS = 48
# DRAM timing is computed in cycles at a fixed 1 GHz (DRAM_FREQUENCY,
# `dram_perf_model.cc:80-115`), i.e. 1 cycle = 1 ns.
DRAM_FREQ_MHZ = 1000


@dataclasses.dataclass(frozen=True)
class CacheLevelParams:
    """One cache level (`carbon_sim.cfg:207-230` [l1_icache/T1] etc.)."""

    num_sets: int             # MAX across tiles (array allocation size)
    num_ways: int             # MAX across tiles
    data_access_cycles: int
    tags_access_cycles: int
    sequential: bool          # perf_model_type (parallel|sequential)
    track_miss_types: bool = False
    # per-line read/write access counters, histogram-classified when the
    # line leaves the cache (`cache/cache_line_utilization.h`; the MOSI
    # L2 controller's eviction/invalidation hook points,
    # `pr_l1_pr_l2_dram_directory_mosi/l2_cache_cntlr.cc:120`)
    track_line_utilization: bool = False
    # `replacement_policy` (`carbon_sim.cfg:213`): lru | round_robin
    # (factory `CacheReplacementPolicy::create`)
    replacement: str = "lru"
    # `num_banks` (`carbon_sim.cfg:212,223,234`): in the reference this
    # knob has NO timing effect — its only consumer is the McPAT cache
    # config (`mcpat_cache_interface.cc:226`); parsed and fed to the
    # energy model accordingly
    num_banks: int = 1
    # heterogeneous per-tile geometries (`misc/config.h:92-100` model_list
    # cache types): None = homogeneous; else int tuples of length T.  The
    # dense arrays are padded to the MAX geometry; per-tile set moduli and
    # way counts mask the engine's indexing/victim picks.
    tile_sets: "tuple | None" = None
    tile_ways: "tuple | None" = None
    tile_data_cycles: "tuple | None" = None
    tile_tags_cycles: "tuple | None" = None

    @property
    def sets_mod(self):
        """Per-tile set modulus: int (homogeneous) or np int32[T]."""
        if self.tile_sets is None:
            return self.num_sets
        import numpy as np

        return np.asarray(self.tile_sets, np.int32)

    @property
    def ways_limit(self):
        """Per-tile way count for victim masking: None or np int32[T]."""
        if self.tile_ways is None:
            return None
        import numpy as np

        return np.asarray(self.tile_ways, np.int32)

    @classmethod
    def merge(cls, per_tile: "list[CacheLevelParams]") -> "CacheLevelParams":
        """One padded level over heterogeneous per-tile configurations."""
        first = per_tile[0]
        if all(p == first for p in per_tile):
            return first
        if any(p.replacement != first.replacement for p in per_tile):
            raise NotImplementedError(
                "mixed replacement policies across tiles of one cache "
                "level are not supported (policy is compile-time)")
        if any(p.sequential != first.sequential for p in per_tile):
            raise NotImplementedError(
                "mixed perf_model_type across tiles is not supported")

        def per(vals, homog_ok=True):
            return None if homog_ok and len(set(vals)) == 1 else tuple(vals)

        sets = [p.num_sets for p in per_tile]
        ways = [p.num_ways for p in per_tile]
        data = [p.data_access_cycles for p in per_tile]
        tags = [p.tags_access_cycles for p in per_tile]
        return cls(
            num_sets=max(sets), num_ways=max(ways),
            data_access_cycles=first.data_access_cycles,
            tags_access_cycles=first.tags_access_cycles,
            sequential=first.sequential,
            track_miss_types=any(p.track_miss_types for p in per_tile),
            track_line_utilization=any(
                p.track_line_utilization for p in per_tile),
            replacement=first.replacement,
            tile_sets=per(sets), tile_ways=per(ways),
            tile_data_cycles=per(data), tile_tags_cycles=per(tags),
        )

    # CachePerfModel::getLatency (`cache_perf_model_{parallel,sequential}.h`)
    # — int when homogeneous, np int64[T] when per-tile (either broadcasts
    # through the engine's jnp cost math)
    @property
    def tags_cycles(self):
        if self.tile_tags_cycles is None:
            return self.tags_access_cycles
        import numpy as np

        return np.asarray(self.tile_tags_cycles, np.int64)

    @property
    def data_and_tags_cycles(self):
        if not self.sequential:
            # parallel tag/data: tags don't add — per-tile only when the
            # data cycles themselves vary (a 0-d array here would crash
            # the golden model's per-tile indexing)
            if self.tile_data_cycles is None:
                return self.data_access_cycles
            import numpy as np

            return np.asarray(self.tile_data_cycles, np.int64)
        if self.tile_data_cycles is None and self.tile_tags_cycles is None:
            return self.data_access_cycles + self.tags_access_cycles
        import numpy as np

        data = np.asarray(
            self.tile_data_cycles
            if self.tile_data_cycles is not None
            else self.data_access_cycles, np.int64)
        tags = np.asarray(
            self.tile_tags_cycles
            if self.tile_tags_cycles is not None
            else self.tags_access_cycles, np.int64)
        return data + tags

    # Defaults per level = the T1 configuration (`carbon_sim.cfg:207-230`)
    _DEFAULTS = {
        "l1_icache": dict(size_kb=16, assoc=4, data=1, tags=1),
        "l1_dcache": dict(size_kb=32, assoc=4, data=1, tags=1),
        "l2_cache": dict(size_kb=512, assoc=8, data=8, tags=3),
    }

    @classmethod
    def from_config(cls, cfg, section: str, line_size: int) -> "CacheLevelParams":
        level = section.split("/")[0]
        d = cls._DEFAULTS.get(level, cls._DEFAULTS["l1_dcache"])
        size_kb = cfg.get_int(f"{section}/cache_size", d["size_kb"])
        assoc = cfg.get_int(f"{section}/associativity", d["assoc"])
        num_lines = size_kb * 1024 // line_size
        num_sets = max(1, num_lines // assoc)
        if num_sets * assoc != num_lines:
            raise ValueError(
                f"[{section}] cache_size/associativity does not tile: "
                f"{num_lines} lines / {assoc} ways"
            )
        return cls(
            num_sets=num_sets,
            num_ways=assoc,
            data_access_cycles=cfg.get_int(f"{section}/data_access_time",
                                           d["data"]),
            tags_access_cycles=cfg.get_int(f"{section}/tags_access_time",
                                           d["tags"]),
            sequential=cfg.get_string(f"{section}/perf_model_type", "parallel")
            == "sequential",
            track_miss_types=cfg.get_bool(f"{section}/track_miss_types", False),
            track_line_utilization=cfg.get_bool(
                f"{section}/track_cache_line_utilization", False),
            replacement=cfg.get_string(f"{section}/replacement_policy",
                                       "lru").strip(),
            num_banks=cfg.get_int(f"{section}/num_banks", 1),
        )


def _auto_directory_access_cycles(directory_size_bytes: int) -> int:
    """`directory_cache.cc:293-330` size→cycles staircase."""
    kb = math.ceil(directory_size_bytes / 1024)
    for limit, cycles in ((16, 1), (32, 2), (64, 4), (128, 6), (256, 8),
                          (512, 10), (1024, 13), (2048, 16)):
        if kb <= limit:
            return cycles
    return 20


# `[dram_directory] directory_type`, in the kernels' SCHEME_* order
# (csrc/mem_common.cuh)
SCHEMES = ("full_map", "limited_no_broadcast", "ackwise",
           "limited_broadcast", "limitless")


@dataclasses.dataclass(frozen=True)
class MemParams:
    n_tiles: int
    line_size: int
    line_bits: int            # log2(line_size)
    protocol: str             # caching_protocol/type
    l1i: CacheLevelParams
    l1d: CacheLevelParams
    l2: CacheLevelParams
    # directory slice per home tile (`[dram_directory]`)
    dir_sets: int
    dir_ways: int
    dir_access_cycles: int
    dir_type: str             # full_map | ackwise | limited_* | limitless
    max_hw_sharers: int
    limitless_trap_cycles: int
    # dram (`[dram]`)
    dram_latency_ns: int
    dram_processing_ns: int   # line_size / bandwidth + 1 (`dram_perf_model.cc:91`)
    dram_queue_type: str      # "disabled" | basic | history_list | ...
    mc_tiles: tuple           # tiles with memory controllers (home slices)
    # memory-network zero-load model (hop-counter math; contention separate)
    net_kind: str             # magic | emesh_hop_counter | atac
    net_freq_mhz: int
    mesh_width: int
    hop_latency_cycles: int
    flit_width_bits: int
    dir_freq_mhz: int         # DIRECTORY domain frequency
    # DVFS domain ids per module for synchronization delay
    # (CORE, L1_ICACHE, L1_DCACHE, L2_CACHE, DIRECTORY, NETWORK_MEMORY)
    module_domains: tuple
    sync_delay_cycles: int    # [dvfs] synchronization_delay
    # engine knobs
    icache_modeling: bool
    func_mem_words: int       # functional memory size (0 = disabled)
    # how many requester slot-starts run per engine iteration: >1 lets a
    # record whose slots HIT the L1 complete several slots per iteration.
    # Measured A/B: a win only for hit-dominated multi-slot records —
    # miss-heavy storms (canneal) pay the repeat for nothing (~1.4x
    # slower at 64 tiles), so the default stays 1; opt in per study via
    # `[general] requester_unroll`.  PRIVATE-L2 engines only: the
    # shared-L2 engine's requester phase does not read it (its L1-only
    # hit path is already a single cheap lookup per iteration)
    requester_unroll: int = 1
    # the MEMORY net's contention model: every coherence message routes
    # through it (memory/net.py) — `memory = emesh_hop_by_hop` (per-port
    # queues) or `memory = atac` (hub queues); None for the zero-load nets
    net_hbh: "object | None" = None     # HopByHopParams
    net_atac: "object | None" = None    # AtacParams

    @property
    def req_bits(self) -> int:
        return NUM_MSG_TYPE_BITS + NUM_PHYSICAL_ADDRESS_BITS

    @property
    def rep_bits(self) -> int:
        return self.req_bits + self.line_size * 8

    @property
    def sharer_words(self) -> int:
        return (self.n_tiles + 31) // 32

    @property
    def is_mosi(self) -> bool:
        """O-state protocol (`pr_l1_pr_l2_dram_directory_mosi/`): owner
        retains dirty data on read-sharing; reads are served cache-to-cache
        from a sharer instead of DRAM."""
        return self.protocol == "pr_l1_pr_l2_dram_directory_mosi"

    @property
    def is_shl2(self) -> bool:
        """A shared-L2 protocol (`pr_l1_sh_l2_msi` / `_mesi`): the
        directory is embedded in each home's L2 slice
        (memory/engine_shl2.py)."""
        return self.protocol.startswith("pr_l1_sh_l2")

    @classmethod
    def from_config(cls, sc: SimConfig) -> "MemParams":
        cfg = sc.cfg
        T = sc.application_tiles
        if T > 8190 and cfg.get_string(
                "caching_protocol/type",
                "pr_l1_pr_l2_dram_directory_msi").startswith("pr_l1_pr_l2"):
            # packed directory-entry words carry owner/nsharers in
            # 13-bit fields (memory/state.py DIR_ID_BITS); the shared-L2
            # engines keep plain int32 arrays and have no such limit
            raise NotImplementedError(
                "private-L2 directory protocols support at most 8190 "
                "tiles")
        spec = sc.tile_spec(0)
        l1d_sec = f"l1_dcache/{spec.l1_dcache_type}"
        line = cfg.get_int(f"{l1d_sec}/cache_line_size", 64)
        line_bits = line.bit_length() - 1
        if 1 << line_bits != line:
            raise ValueError(f"cache_line_size {line} is not a power of 2")
        # heterogeneous per-tile cache types (`misc/config.h:92-100`,
        # `[tile] model_list`): build each tile's level config, then merge
        # into ONE padded level with per-tile set/way/timing vectors
        per_level: dict[str, list] = {"l1_icache": [], "l1_dcache": [],
                                      "l2_cache": []}
        for t in range(T):
            s = sc.tile_spec(t)
            for level, typ in (("l1_icache", s.l1_icache_type),
                               ("l1_dcache", s.l1_dcache_type),
                               ("l2_cache", s.l2_cache_type)):
                other_line = cfg.get_int(f"{level}/{typ}/cache_line_size",
                                         line)
                if other_line != line:
                    raise NotImplementedError(
                        "mixed cache_line_size across tiles is not "
                        "supported (the line is the coherence unit)")
                per_level[level].append(
                    CacheLevelParams.from_config(cfg, f"{level}/{typ}",
                                                 line))
        l1i = CacheLevelParams.merge(per_level["l1_icache"])
        l1d = CacheLevelParams.merge(per_level["l1_dcache"])
        l2 = CacheLevelParams.merge(per_level["l2_cache"])

        # --- memory controllers (`memory_manager.cc:214-278`) -------------
        num_mc_str = cfg.get_string("dram/num_controllers", "ALL")
        positions = cfg.get_string("dram/controller_positions", "").strip()
        if num_mc_str == "ALL":
            mc_tiles = tuple(range(T))
        else:
            num_mc = int(num_mc_str)
            if positions:
                mc_tiles = tuple(
                    int(x) for x in positions.replace('"', "").split(",") if x.strip()
                )
                if len(mc_tiles) != num_mc:
                    raise ValueError(
                        "dram/controller_positions length != num_controllers"
                    )
            else:
                # Even striping (NetworkModel::computeMemoryControllerPositions
                # default: evenly spaced over the tile array).
                stride = T // num_mc
                mc_tiles = tuple((i * stride) for i in range(num_mc))

        # --- directory slice sizing (`directory_cache.cc:244-264`) --------
        dir_ways = cfg.get_int("dram_directory/associativity", 16)
        entries_str = cfg.get_string("dram_directory/total_entries", "auto")
        n_slices = len(mc_tiles)
        # auto-size from the largest ACTUAL per-tile L2 (max sets x max
        # ways could pair maxima from different tiles and oversize it)
        l2_size_kb = max(
            p.num_sets * p.num_ways for p in per_level["l2_cache"]
        ) * line // 1024
        if entries_str == "auto":
            num_sets = math.ceil(
                2.0 * l2_size_kb * 1024 * T / (line * dir_ways * n_slices)
            )
            num_sets = 1 << max(0, (num_sets - 1).bit_length())  # ceil pow2
            total_entries = num_sets * dir_ways
        else:
            total_entries = int(entries_str)
        dir_sets = max(1, total_entries // dir_ways)

        dir_type = cfg.get_string("dram_directory/directory_type", "full_map")
        if dir_type not in SCHEMES:
            raise ValueError(
                f"[dram_directory] directory_type = {dir_type!r}: one of "
                f"{', '.join(SCHEMES)}")
        # Directory entry size for the access-time staircase: reference uses
        # max_hw_sharers-dependent sizes (`directory_cache.cc:50`); full_map
        # entry ~ T bits + owner + state.
        entry_bytes = max(8, sc.application_tiles // 8)
        access_str = cfg.get_string("dram_directory/access_time", "auto")
        if access_str == "auto":
            dir_access = _auto_directory_access_cycles(total_entries * entry_bytes)
        else:
            dir_access = int(access_str)

        # --- dram timing (`dram_perf_model.cc:80-115`) ---------------------
        dram_latency_ns = int(cfg.get_float("dram/latency", 100))
        bw = cfg.get_float("dram/per_controller_bandwidth", 5.0)  # GB/s == B/ns
        dram_processing_ns = int(line / bw) + 1
        dram_queue_enabled = cfg.get_bool("dram/queue_model/enabled", True)
        dram_queue_type = (
            cfg.get_string("dram/queue_model/type", "history_tree")
            if dram_queue_enabled
            else "disabled"
        )

        # --- memory network params -----------------------------------------
        # the zero-load basis as the JAX package reads it
        # (`UserNetworkParams.from_config(sc, "memory")`: the NETWORK_USER
        # domain frequency, the hop-counter math of the configured mesh
        # section), then the contention model of emesh_hop_by_hop or atac
        from graphite_tpu_torch.models.network_atac import AtacParams
        from graphite_tpu_torch.models.network_hop_by_hop import (
            HopByHopParams,
        )
        from graphite_tpu_torch.models.network_user import (
            _network_domain_freq_mhz,
        )

        mem_kind = sc.network_types[1]
        if mem_kind not in ("magic", "emesh_hop_counter",
                            "emesh_hop_by_hop", "atac"):
            raise ValueError(f"unsupported memory network model: {mem_kind}")
        net_freq = _network_domain_freq_mhz(sc)
        net_kind, mesh_w, hop_cycles, flit_bits = mem_kind, 0, 2, -1
        net_hbh = net_atac = None
        if mem_kind in ("emesh_hop_counter", "emesh_hop_by_hop"):
            section = f"network/{mem_kind}"
            net_kind = "emesh_hop_counter"
            hop_cycles = (cfg.get_int(f"{section}/router/delay", 1)
                          + cfg.get_int(f"{section}/link/delay", 1))
            flit_bits = cfg.get_int(f"{section}/flit_width", 64)
            mesh_w, _ = mesh_dims(T)
        if mem_kind == "emesh_hop_by_hop":
            net_hbh = HopByHopParams.from_config(sc, "memory")
        elif mem_kind == "atac":
            net_atac = AtacParams.from_config(sc, "memory")

        # --- DVFS domains for synchronization delay ------------------------
        from graphite_tpu_torch.models.dvfs import (
            module_domain_index, module_freq_mhz,
        )

        modules = ("CORE", "L1_ICACHE", "L1_DCACHE", "L2_CACHE", "DIRECTORY",
                   "NETWORK_MEMORY")
        module_domains = tuple(module_domain_index(cfg, m) for m in modules)
        dir_freq_mhz = module_freq_mhz(cfg, "DIRECTORY")

        protocol = cfg.get_string(
            "caching_protocol/type", "pr_l1_pr_l2_dram_directory_msi")
        requester_unroll = cfg.get_int("general/requester_unroll", 1)
        if requester_unroll > 1 and protocol.startswith("pr_l1_sh_l2"):
            raise NotImplementedError(
                "[general] requester_unroll > 1 applies to the private-L2 "
                "engines only (the shared-L2 requester phase does not "
                "read it)")
        return cls(
            dir_freq_mhz=dir_freq_mhz,
            n_tiles=T,
            line_size=line,
            line_bits=line_bits,
            protocol=protocol,
            l1i=l1i,
            l1d=l1d,
            l2=l2,
            dir_sets=dir_sets,
            dir_ways=dir_ways,
            dir_access_cycles=dir_access,
            dir_type=dir_type,
            max_hw_sharers=cfg.get_int("dram_directory/max_hw_sharers", 64),
            limitless_trap_cycles=cfg.get_int(
                "limitless/software_trap_penalty", 200
            ),
            dram_latency_ns=dram_latency_ns,
            dram_processing_ns=dram_processing_ns,
            dram_queue_type=dram_queue_type,
            mc_tiles=mc_tiles,
            net_kind=net_kind,
            net_freq_mhz=net_freq,
            mesh_width=mesh_w,
            hop_latency_cycles=hop_cycles,
            flit_width_bits=flit_bits,
            module_domains=module_domains,
            sync_delay_cycles=cfg.get_int("dvfs/synchronization_delay", 2),
            icache_modeling=cfg.get_bool("general/enable_icache_modeling", False),
            func_mem_words=cfg.get_int("general/functional_memory_kb", 256) * 256,
            requester_unroll=requester_unroll,
            net_hbh=net_hbh,
            net_atac=net_atac,
        )

    def sync_cycles(self, module_a: int, module_b: int) -> int:
        """`Cache::getSynchronizationDelay` (`cache.cc:559-567`): the [dvfs]
        synchronization_delay when the two modules sit in different DVFS
        domains, else 0.  Module indices follow `module_domains` order."""
        if self.module_domains[module_a] == self.module_domains[module_b]:
            return 0
        return self.sync_delay_cycles

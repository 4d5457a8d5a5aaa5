"""The benchmark scripts' config text, as a function of the knobs.

A copy of `graphite_tpu/tools/_template.py` `config_text` (the port
imports nothing of the JAX package): `bench.py`'s 64-tile iocoom + MSI
coherence companion is `config_text(64, core="iocoom", shared_mem=True,
clock_scheme="lax")`.
"""

from __future__ import annotations


def config_text(tiles: int, *, core: str = "simple",
                network: str = "emesh_hop_counter",
                shared_mem: bool = False,
                protocol: str = "pr_l1_pr_l2_dram_directory_msi",
                scheme: str = "full_map", max_hw_sharers: int = 2,
                clock_scheme: str = "lax_barrier",
                dvfs: bool = False) -> str:
    dvfs_section = """
[dvfs]
technology_node = 22
max_frequency = 1.0
synchronization_delay = 2
[dvfs/domains]
domains = "<1.0, CORE, L1_ICACHE, L1_DCACHE, L2_CACHE, DIRECTORY, NETWORK_USER, NETWORK_MEMORY>"
""" if dvfs else ""
    return f"""
[general]
total_cores = {tiles}
mode = lite
max_frequency = 1.0
enable_shared_mem = {"true" if shared_mem else "false"}
[tile]
model_list = <{tiles}, {core}>
[caching_protocol]
type = {protocol}
[dram_directory]
directory_type = {scheme}
max_hw_sharers = {max_hw_sharers}
[network]
user = {network}
memory = {network}
[network/emesh_hop_counter]
flit_width = 64
[network/emesh_hop_counter/router]
delay = 1
[network/emesh_hop_counter/link]
delay = 1
[network/emesh_hop_by_hop]
flit_width = 64
[network/emesh_hop_by_hop/router]
delay = 1
num_flits_per_port_buffer = 4
[network/emesh_hop_by_hop/link]
delay = 1
[core/static_instruction_costs]
generic = 1
mov = 1
ialu = 1
falu = 3
fmul = 5
[branch_predictor]
type = one_bit
mispredict_penalty = 14
size = 1024
[clock_skew_management]
scheme = {clock_scheme}
[clock_skew_management/lax_barrier]
quantum = 1000
{dvfs_section}
"""

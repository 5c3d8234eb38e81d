"""What every run shares: the cell's files found by name, the device, the
set-up clock, the program's configuration, and the card's state.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, whose file is given in ``configs``, and a traffic mix, the
data file ``portbench/traffic/<traffic>.json``. The traffic file's
``driver`` names the general driver that serves it: the module
``portbench/harness/<driver>.py`` (``fleet``, ``live``), which gives
``serve``, ``served_once`` and ``reference``. Nothing here lists cells,
drivers or metrics.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# Forbidden in the process that prints a result: the JAX stack and the JAX
# package (top-level module names, compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "msckf_mono_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's clock."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload entry with its configuration and traffic files read."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    bench: dict

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, section: str):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]

    def driver(self):
        """The module that serves this cell's traffic, by the name it gives."""
        return importlib.import_module(f"portbench.harness.{self.traffic['driver']}")

    def with_config(self, changes: dict) -> "Cell":
        """This cell with its configuration's groups updated by ``changes``
        ({group: {key: value}}, or {key: value} at the top level)."""
        config = copy.deepcopy(self.config)
        for k, v in changes.items():
            if isinstance(v, dict):
                config[k].update(v)
            else:
                config[k] = v
        return dataclasses.replace(self, config=config)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its files read."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{entry['traffic']}.json")
    return Cell(name, entry, config, traffic, bench)


def build_config(config: dict, batch: int, mod):
    """The filter configuration of a configuration file, as ``mod`` (the
    program's ``utils.config`` or the reference's) types it. A file's
    ``staged_chunk_rows`` sizes the row pipeline's chunks to the batch, as
    the serving preset does: ``staged_chunk = max(2, staged_chunk_rows // B)``."""
    p = config["filter_config"]

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    shapes = fields(p["shapes"])
    if "staged_chunk_rows" in config:
        shapes["staged_chunk"] = max(2, int(config["staged_chunk_rows"]) // batch)
    return mod.MsckfConfig(camera=mod.CameraConfig(**fields(p["camera"])),
                           noise=mod.NoiseConfig(**fields(p["noise"])),
                           filter=mod.FilterConfig(**fields(p["filter"])),
                           shapes=mod.ShapeConfig(**shapes))


def dtype_of(config: dict):
    return {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]


class Device:
    """The device a run serves from: ``cuda`` on the chip; ``cpu`` only for
    the CPU tests, which drive the harness without a chip."""

    def __init__(self, kind: str):
        self.kind = kind
        self.cuda = kind == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def describe(self, chips: int) -> dict:
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak)}


def require_chips(chips: int):
    """Exit without a result where the cell's cards are not there."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} found")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class Clock:
    """Seconds since the process started (set-up is counted from there)."""

    def __init__(self):
        self.t0 = time.perf_counter() - process_age_s()

    def now(self) -> float:
        return time.perf_counter() - self.t0


def local_cpus(dev):
    """The card's local CPUs as the kernel lists them, or None."""
    if not dev.cuda:
        return None
    p = torch.cuda.get_device_properties(0)
    try:
        bus = f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:{p.pci_device_id:02x}.0"
        with open(f"/sys/bus/pci/devices/{bus}/local_cpulist") as f:
            return f.read().strip()
    except (AttributeError, OSError):
        return None


def placement(dev) -> str:
    """The CPUs this process may run on, and the card's local CPUs."""
    mine = sorted(os.sched_getaffinity(0))
    return f"CPUs {mine[0]}-{mine[-1]} ({len(mine)}), the card's local CPUs {local_cpus(dev)}"


def clocks(dev) -> str:
    """The card's name, SM clock, power draw and limit, and temperature."""
    if not dev.cuda:
        return "no card"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def free_program(dev):
    """Drop the program's captured graphs and cached blocks."""
    import gc

    from msckf_mono_tpu_torch.ops import cuda_graph

    cuda_graph.clear_cache()
    gc.collect()
    if dev.cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def launch_counts():
    """The program's counts of its kernel launches (gamma, FAST, KLT), which
    a replayed graph adds to as an eager run would."""
    from msckf_mono_tpu_torch.ops import cuda_graph

    return cuda_graph.counts()

"""Two processes joined by ``torch.distributed`` into one sharded fleet (port of ``tools/run_two_host_sim.py``).

    python -m msckf_mono_tpu_torch.parallel.two_host_sim --cpu              # 2 processes x 2 CPU shards
    python -m msckf_mono_tpu_torch.parallel.two_host_sim --batch 1024 --frames 200   # on the card

The launcher starts two worker processes that join one process group
(``init_method="tcp://127.0.0.1:<free port>"``) and run one global fleet,
drawn once and split into global shards, through
``sharding.make_sharded_run``: on the CPU two shards a process, gloo; on the
card one shard a process, on its own card with NCCL where every rank has
one, else both on ``cuda:0`` with gloo (NCCL refuses two ranks on one
device). Each worker also runs the first half of the frames, saves the
sharded fleet (``parallel/checkpoint``), restores it into a fresh template
and resumes the second half. Then one process runs the same global shard
layout alone.

Each run prints a ``RESULT {json}`` line: the fleet's metrics, a trajectory
checksum (sum of p^2 + |q| over every filter and frame, all-reduced), and
its frame time, rate, gamma and triangulation launches, peak memory,
capture, all-reduce, save and restore times. The launcher's last line is one JSON object whose
``ok`` says that the two ranks agree exactly, that their totals and maxima
equal the one-process run's exactly and their means and checksum within
1e-6 relative, and that every resumed fleet equals its uninterrupted run
bit for bit.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

WORLD = 2
EXACT = ("max_pos_cov_trace", "total_residualized", "total_row_overflow", "total_staged_overflow")
RELATIVE = ("mean_pos_cov_trace", "mean_cam_count", "traj_checksum")
REL_TOL = 1e-6


def _free_port() -> int:
    with contextlib.closing(socket.socket(socket.AF_INET, socket.SOCK_STREAM)) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _layout(cpu: bool):
    """(backend, each rank's devices): the global shard layout."""
    import torch

    if cpu:
        return "gloo", [["cpu", "cpu"] for _ in range(WORLD)]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    if torch.cuda.device_count() >= WORLD:
        return "nccl", [[f"cuda:{r}"] for r in range(WORLD)]
    return "gloo", [["cuda:0"] for _ in range(WORLD)]


def _sync(mesh):
    import torch

    for d in set(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_fleet(mesh, batch: int, frames: int, ckpt: str) -> dict:
    """One global fleet of ``batch`` filters over ``frames`` frames of the
    synthetic world at the serving configuration, this process's shards of
    it on ``mesh``; then the half-run, save, restore and resume."""
    import torch
    import torch.distributed as dist

    from msckf_mono_tpu_torch.core.init import ground_truth_init
    from msckf_mono_tpu_torch.core.types import _leaves, tree_map
    from msckf_mono_tpu_torch.data import synthetic
    from msckf_mono_tpu_torch.ops import psd_cuda, triangulate_cuda
    from msckf_mono_tpu_torch.parallel import checkpoint, montecarlo, sharding
    from msckf_mono_tpu_torch.utils.config import serving_config

    cfg = serving_config(batch)
    device = mesh.devices[0]
    seq = synthetic.generate(cfg, n_frames=frames, seed=0, pixel_noise=0.5)
    imu = ground_truth_init(p_I_G=[5.0, 0.0, 0.0], q_IG=[1, 0, 0, 0],
                            v_I_G=[0.0, 5.0 * 0.35, 0.2 * 1.4], b_g=seq.b_g, b_a=seq.b_a,
                            dtype=torch.float32, device=device)
    bframes = montecarlo.broadcast_frames(
        synthetic.to_frame_inputs(seq, torch.float32, device=device), batch)

    # drawn once for the whole fleet, then split: filter k is one draw
    # everywhere (key 0's draws do not depend on the fleet size either, so a
    # shard's rows equal the whole fleet's)
    def fleet():
        return sharding.shard_batch(montecarlo.make_fleet(
            cfg, imu, batch, dtype=torch.float32, device=device), mesh)

    def first(n):
        return tree_map(lambda x: x[:n], bframes)

    run = sharding.make_sharded_run(cfg, mesh)
    rec = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    run(fleet(), first(2))             # capture and warm-up, outside the count
    _sync(mesh)
    rec["capture_s"] = time.perf_counter() - t0

    states = fleet()
    _sync(mesh)
    launches = psd_cuda.gamma_psd.launches
    tri_launches = triangulate_cuda.triangulate_tracks.launches
    t0 = time.perf_counter()
    final, outs, metrics = run(states, bframes)
    _sync(mesh)
    seconds = time.perf_counter() - t0
    rec["gamma_launches"] = psd_cuda.gamma_psd.launches - launches
    rec["triangulate_launches"] = triangulate_cuda.triangulate_tracks.launches - tri_launches
    rec.update(seconds=seconds, frame_ms=1e3 * seconds / frames,
               frame_steps_per_s=batch * frames / seconds)
    rec.update({k: float(v) for k, v in metrics.items()})
    t0 = time.perf_counter()
    sharding.fleet_metrics(final, mesh)
    _sync(mesh)
    rec["allreduce_s"] = time.perf_counter() - t0

    checksum = sum(float((o.p_I_G.double() ** 2).sum() + o.q_IG.double().abs().sum())
                   for o in outs.shards)
    total = torch.tensor([checksum], dtype=torch.float64)
    if mesh.group is not None:
        if dist.get_backend(mesh.group) == "nccl":
            total = total.to(device)
        dist.all_reduce(total, group=mesh.group)
    rec["traj_checksum"] = float(total[0])
    if device.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30

    half = frames // 2
    mid, _, _ = run(fleet(), first(half))
    _sync(mesh)
    t0 = time.perf_counter()
    path = checkpoint.save(ckpt, mid, step=half)
    rec["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = checkpoint.restore(path, fleet())
    _sync(mesh)
    rec["restore_s"] = time.perf_counter() - t0

    def equal(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in zip(_leaves(a), _leaves(b)))

    rec["restored_equal"] = all(equal(a, b) for a, b in zip(restored.shards, mid.shards))
    resumed, _, _ = run(restored, tree_map(lambda x: x[half:], bframes))
    rec["resumed_equal"] = all(equal(a, b) for a, b in zip(resumed.shards, final.shards))
    rec.update(rank=mesh.rank, shards=list(mesh.shard_ids), devices=[str(d) for d in mesh.devices])
    return rec


def _child(args):
    import torch
    import torch.distributed as dist

    from msckf_mono_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    backend, devices = _layout(args.cpu)
    if args.reference:
        mesh = sharding.make_mesh([d for ds in devices for d in ds])
    else:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{args.port}",
                                world_size=WORLD, rank=args.worker,
                                timeout=datetime.timedelta(seconds=args.timeout))
        mesh = sharding.make_mesh(devices[args.worker])
    try:
        rec = run_fleet(mesh, args.batch, args.frames, args.ckpt)
    finally:
        if not args.reference:
            dist.destroy_process_group()
    rec["backend"] = None if args.reference else backend
    print("RESULT " + json.dumps(rec, sort_keys=True), flush=True)


def _parse(out: str) -> dict:
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError("no RESULT line in: " + out[-2000:])


def _checks(ref: dict, workers: list) -> dict:
    w0, w1 = workers
    keys = EXACT + RELATIVE
    return {
        "ranks_agree": all(w0[k] == w1[k] for k in keys),
        "totals_equal": all(w0[k] == ref[k] for k in EXACT),
        "means_within_1e-6": all(abs(w0[k] - ref[k]) <= REL_TOL * max(abs(ref[k]), 1e-30)
                                 for k in RELATIVE),
        "restored_equal": all(r["restored_equal"] for r in [ref, *workers]),
        "resumed_equal": all(r["resumed_equal"] for r in [ref, *workers]),
    }


def launch(args) -> dict:
    me = [sys.executable, "-u", "-m", "msckf_mono_tpu_torch.parallel.two_host_sim",
          "--batch", str(args.batch), "--frames", str(args.frames),
          "--timeout", str(args.timeout)] + (["--cpu"] if args.cpu else [])
    # the children import this package from where the launcher found it
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    root = tempfile.mkdtemp(prefix="two_host_sim_")
    procs, logs = [], []

    def start(extra, name):
        out = open(os.path.join(root, name + ".out"), "w+")
        err = open(os.path.join(root, name + ".err"), "w+")
        logs.append((out, err))
        return subprocess.Popen(me + extra, stdout=out, stderr=err, env=env, text=True)

    def finish(p, name, log):
        try:
            p.wait(timeout=args.timeout)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{name} did not finish within {args.timeout} s") from None
        out, err = log
        out.seek(0)
        err.seek(0)
        if p.returncode:
            raise RuntimeError(f"{name} failed (exit {p.returncode}):\n" + err.read()[-3000:])
        return _parse(out.read())

    try:
        procs.append(start(["--reference", "--ckpt", os.path.join(root, "reference")], "reference"))
        ref_rec = finish(procs[0], "the one-process run", logs[0])
        port = _free_port()
        for r in range(WORLD):
            procs.append(start(["--worker", str(r), "--port", str(port),
                                "--ckpt", os.path.join(root, "workers")], f"worker{r}"))
        workers = [finish(procs[1 + r], f"worker {r}", logs[1 + r]) for r in range(WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()
        shutil.rmtree(root, ignore_errors=True)
    checks = _checks(ref_rec, workers)
    metrics = {k: ref_rec[k] for k in EXACT + RELATIVE}
    return {"ok": all(checks.values()), "checks": checks, "metrics": metrics,
            "reference": ref_rec, "workers": workers}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--batch", type=int, default=16, help="global fleet size")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each process (and each collective) may take")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--reference", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ckpt", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.reference or args.worker is not None:
        return _child(args)
    rec = launch(args)
    print(json.dumps(rec, sort_keys=True))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

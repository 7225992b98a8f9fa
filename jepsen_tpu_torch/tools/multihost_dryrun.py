#!/usr/bin/env python3
"""Processes joined into one job through `parallel.init_distributed`,
each on the devices it is given: shard identity, the global-dp check and
the `analyze-store --mesh` sweep.

    python -m jepsen_tpu_torch.tools.multihost_dryrun [--processes N]
        [--devices cuda,cuda] [--sweep-device cuda] [--what all]

The port's counterpart of the reference's `__graft_entry__`
`dryrun_multichip`, `dryrun_multihost` and `_dryrun_mesh_sweep`. One part
runs in this process:

  chip      every device path over the mesh of `--devices` in one
            process (the reference's `dryrun_multichip` at small
            sizes): ragged append histories through `check_bucketed`
            (fused and two-pass), a long history through
            `check_long_history` over `sp_mesh` (dense, then condensed
            past a lowered limit), the dense register tier and the wr
            edge batch with `devices=`: every verdict equal to one
            device's.

The others spawn N processes (`python -m` this module) with the
reference's coordinator variables (`JAX_COORDINATOR_ADDRESS` on
127.0.0.1 at a free port, `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`), so
they join one gloo group:

  identity  each process joins and reports `mesh.resolve_shard()`: rank
            k of N must be shard k/N.
  global    each process builds `parallel.make_mesh` over its own
            `--devices` (a list that may repeat a device), checks its
            contiguous slice of one deterministic batch of list-append
            histories (history 0 carries a G1c pair; some ragged) with
            `parallel.check_joined`, which all-gathers every rank's
            flags over gloo; every rank's gathered verdicts must equal
            this process's `check_bucketed` of the whole batch on the
            same mesh.
  sweep     a synthetic store (6 runs of 48 txns over 6 keys, every 3rd
            with a G1c pair: the reference's dryrun store) swept once
            by one process, and once by N joined processes with
            `analyze-store --mesh` and no `JEPSEN_TPU_MESH_SHARDS`:
            every run's results.json and results.edn byte-identical,
            the shard journals a partition of the runs, the coordinator
            exiting as the one process did.

Prints one line a part and exits 0, or raises. `--devices` names the
mesh of `chip` and of every process of `global`, a comma list that may
repeat a device (default `cuda`: the card; `cpu,cpu,cpu,cpu` on the
CPU); `--sweep-device` is the sweep's `--device` (default cuda, where
each process sweeps on its visible cards; `cpu` on the CPU). A list
that names cuda with no card raises `DeviceUnavailable`. Nothing here
needs more than one card: a repeated device stands in for several.
`extra` (of `global_dp` and `mesh_sweep`) adds to the joined
processes' environment, e.g. a `sitecustomize` on their PYTHONPATH
that counts their kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: The env of a joined job, the reference's names, and the gates a
#: sweep of the parent's environment must not carry into the shards.
JOB_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
            "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
SHARD_VARS = ("JEPSEN_TPU_MESH", "JEPSEN_TPU_MESH_SHARD",
              "JEPSEN_TPU_MESH_SHARDS")
#: The global part's batch: history lengths (ragged), G1c in history 0.
GLOBAL_T = (64, 40, 90, 64, 30, 120, 64)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def job_env(port: int, rank: int, n: int, extra: dict | None = None) -> dict:
    """The parent's environment with the coordinator variables of rank
    `rank` of `n` at 127.0.0.1:`port`, no shard count, the repo on
    PYTHONPATH."""
    env = {k: v for k, v in os.environ.items()
           if k not in JOB_VARS + SHARD_VARS}
    env.update({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(rank),
                "PYTHONPATH": os.pathsep.join(
                    [str(ROOT)] + [p for p in [env.get("PYTHONPATH")]
                                   if p])})
    env.update(extra or {})
    return env


def run_job(argvs: list[list[str]], n: int, timeout: float,
            extra: dict | None = None, cwd: Path = ROOT) -> list:
    """Start the n processes of one job (argv k for rank k) at once and
    wait for all of them: [(exit code, stdout, stderr)] by rank. A
    process that outlasts `timeout` is killed with the rest, and the
    job raises."""
    port = free_port()
    procs = [subprocess.Popen(argv, cwd=cwd, env=job_env(port, k, n, extra),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for k, argv in enumerate(argvs)]
    out = []
    try:
        for k, p in enumerate(procs):
            try:
                o, e = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {k} of the job timed out "
                                   f"after {timeout}s") from None
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _ok_line(what: str, rank: int, res: tuple, tag: str) -> str:
    rc, o, e = res
    lines = [ln for ln in o.splitlines() if ln.startswith(tag)]
    if rc != 0 or not lines:
        tail = " | ".join((e or o).strip().splitlines()[-4:])
        raise RuntimeError(f"{what}: rank {rank} rc={rc}: {tail}")
    return lines[-1]


def _me(*args: str) -> list[str]:
    return [sys.executable, "-m", "jepsen_tpu_torch.tools.multihost_dryrun",
            *args]


def identity(n: int = 2, timeout: float = 120.0) -> list[str]:
    """Each of n joined processes' `resolve_shard()`; raises unless rank
    k is shard k/n."""
    got = run_job([_me("--worker", "identity")] * n, n, timeout)
    lines = [_ok_line("identity", k, r, "SHARD_OK") for k, r in
             enumerate(got)]
    for k, ln in enumerate(lines):
        if ln.split()[1] != f"{k}/{n}":
            raise RuntimeError(f"rank {k} resolved {ln}")
    return lines


def mesh_devices(devices: str) -> list:
    """A comma list of device names as torch devices; raises
    DeviceUnavailable for cuda without a card."""
    from jepsen_tpu_torch.devices import resolve_device
    return [resolve_device(d.strip()) for d in devices.split(",")]


def global_dp(n: int = 2, devices: str = "cuda", timeout: float = 180.0,
              extra: dict | None = None) -> list[str]:
    """The global-dp check (module doc) over n processes, each on the
    mesh of `devices` (a comma list); returns each rank's line, after
    holding its gathered flags to this process's check of the whole
    batch on the same mesh."""
    from jepsen_tpu_torch import parallel
    mesh = parallel.make_mesh(mesh_devices(devices))
    got = run_job([_me("--worker", "global", "--devices", devices)] * n, n,
                  timeout, extra)
    lines = [_ok_line("global", k, r, "GLOBAL_OK")
             for k, r in enumerate(got)]
    want = parallel.check_bucketed(global_batch(), mesh=mesh)
    if "G1c" not in want[0] or any(want[1:]):
        raise RuntimeError(f"unexpected one-process verdicts {want}")
    for ln in lines:
        if json.loads(ln.split("flags=", 1)[1]) != want:
            raise RuntimeError(f"gathered verdicts {ln} != one-process "
                               f"{want}")
    return lines


def write_store(base: Path) -> None:
    """The reference dryrun's store: 6 runs of 48 txns, K=6, every 3rd
    with a G1c pair, in the two-level layout."""
    from jepsen_tpu_torch.checker.elle import synth
    synth.write_synth_run_store(base, 6, 48, 6, 3)


def mesh_sweep(n: int = 2, device: str = "cuda", store: Path | None = None,
               work: Path | None = None, timeout: float = 300.0,
               extra: dict | None = None) -> dict:
    """One process's `analyze-store` of `store` (default: `write_store`'s)
    against n joined processes' `analyze-store --mesh` of a copy
    (module doc). Returns {"single": dir, "mesh": dir, "rc": the single
    sweep's exit, "rcs": the shards', "runs": run count, "compared":
    files compared byte for byte}; raises on any difference."""
    work = Path(work if work is not None
                else tempfile.mkdtemp(prefix="multihost-"))
    single, meshed = work / "single", work / "mesh"
    if store is None:
        write_store(single)
    else:
        shutil.copytree(store, single)
    shutil.copytree(single, meshed)
    env = {k: v for k, v in os.environ.items()
           if k not in JOB_VARS + SHARD_VARS}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    cli = [sys.executable, "-m", "jepsen_tpu_torch.cli", "analyze-store",
           "--device", device]
    one = subprocess.run(cli + ["--store", str(single)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if one.returncode not in (0, 1):
        raise RuntimeError(f"one-process sweep rc={one.returncode}: "
                           f"{one.stderr[-400:]}")
    got = run_job([cli + ["--store", str(meshed), "--mesh"]] * n, n,
                  timeout, extra={"JEPSEN_TPU_MESH_WAIT_S": "120",
                                  **(extra or {})})
    rcs = [rc for rc, _o, _e in got]
    for k, (rc, o, e) in enumerate(got):
        if rc not in (0, 1):
            raise RuntimeError(f"mesh shard {k} rc={rc}: {e[-400:]}")
    if rcs[0] != one.returncode:
        raise RuntimeError(f"coordinator rc {rcs[0]} != one-process "
                           f"sweep rc {one.returncode}")
    runs = sorted(p.relative_to(single) for p in single.glob("*/*")
                  if (p / "history.jsonl").is_file())
    compared = 0
    for r in runs:
        for art in ("results.json", "results.edn"):
            a, b = single / r / art, meshed / r / art
            if not b.is_file() or a.read_bytes() != b.read_bytes():
                raise RuntimeError(f"mesh sweep's {r}/{art} differs from "
                                   "the one-process sweep's")
            compared += 1
    owner: dict = {}
    for k in range(n):
        jp = meshed / f"verdicts-{k}.jsonl"
        for ln in (jp.read_text().splitlines() if jp.is_file() else []):
            d = json.loads(ln)["dir"]
            if owner.setdefault(d, k) != k:
                raise RuntimeError(f"run {d} journaled by shards "
                                   f"{owner[d]} and {k}")
    if len(owner) != len(runs):
        raise RuntimeError(f"the shard journals cover {len(owner)} of "
                           f"{len(runs)} runs")
    return {"single": single, "mesh": meshed, "rc": one.returncode,
            "rcs": rcs, "runs": len(runs), "compared": compared}


def multichip(devices: str = "cuda") -> list[str]:
    """The `chip` part (module doc) over the mesh of `devices` (a comma
    list); raises on a verdict that differs from one device's."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.checker.elle import encode, kernels, synth, wr
    from jepsen_tpu_torch.checker.knossos import dense
    from jepsen_tpu_torch.checker.knossos import synth as ksynth
    devs = mesh_devices(devices)
    one = devs[0]
    mesh, sp = parallel.make_mesh(devs), parallel.sp_mesh(devs)
    out = []

    def same(what: str, got, want) -> None:
        if got != want:
            raise RuntimeError(f"{what} over {devices}: {got} != {want}")
        out.append(f"{what} ok")

    encs = global_batch()
    for fused in (True, False):
        same(f"bucketed (fused={fused})",
             parallel.check_bucketed(encs, mesh=mesh, fused=fused),
             parallel.check_bucketed(encs, one, fused=fused))
    long = encode.encode_history(synth.synth_append_history(
        700, 16, seed=5, g1c=True))
    for limit in (parallel.DENSE_TXN_LIMIT, 256):
        same(f"long history (dense limit {limit})",
             parallel.check_long_history(long, mesh=sp, dense_limit=limit),
             parallel.check_long_history(long, one, dense_limit=limit))
    regs = [dense.encode_dense_history(ksynth.synth_register_history(
        n_ops=40, n_procs=4, seed=s)) for s in range(len(devs) + 1)]
    same("dense register tier",
         dense.check_encoded_dense_batch(regs, devices=devs),
         dense.check_encoded_dense_batch(regs, one))
    eds = [wr.to_edge_dict(wr.encode_wr_history(synth.wr_run_ops(
        60, 4, seed=s, write_skew=s == 1))) for s in range(3)]
    same("wr edge batch", kernels.check_edge_batch(eds, devices=devs),
         kernels.check_edge_batch(eds, one))
    return out


# -- the processes' bodies ------------------------------------------------

def _worker_identity() -> None:
    from jepsen_tpu_torch import mesh
    shard, count = mesh.resolve_shard()
    print(f"SHARD_OK {shard}/{count}", flush=True)


def global_batch() -> list:
    """The global part's deterministic batch (module doc)."""
    from jepsen_tpu_torch.checker.elle import encode, synth
    return [encode.encode_history(synth.synth_append_history(
        T=t, K=8, seed=s, g1c=(s == 0))) for s, t in enumerate(GLOBAL_T)]


def _worker_global(devices: str) -> None:
    import torch.distributed as dist

    from jepsen_tpu_torch import parallel
    # explicit raises: a worker that never joined must not pass
    if parallel.init_distributed() is not True:
        raise RuntimeError("no coordinator address: the worker did not "
                           "join a job")
    mesh = parallel.make_mesh(mesh_devices(devices))
    # only the joined check runs here (the parent holds the flags to
    # its own), so this process's launches are the global dp's alone
    joined = parallel.check_joined(global_batch(), mesh=mesh)
    print(f"GLOBAL_OK rank={dist.get_rank()}/{dist.get_world_size()} "
          f"mesh={tuple(mesh.devices.shape)} devices={devices} "
          f"flags={json.dumps(joined, sort_keys=True)}", flush=True)
    dist.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="multihost_dryrun")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices", default="cuda")
    ap.add_argument("--sweep-device", default="cuda")
    ap.add_argument("--what", default="all",
                    choices=("chip", "identity", "global", "sweep", "all"))
    ap.add_argument("--worker", choices=("identity", "global"))
    a = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if a.worker == "identity":
        _worker_identity()
        return 0
    if a.worker == "global":
        _worker_global(a.devices)
        return 0
    if a.what in ("chip", "all"):
        print("chip: " + "; ".join(multichip(a.devices)), flush=True)
    if a.what in ("identity", "all"):
        print("identity: " + "; ".join(identity(a.processes)), flush=True)
    if a.what in ("global", "all"):
        print("global: " + "; ".join(global_dp(a.processes, a.devices)),
              flush=True)
    if a.what in ("sweep", "all"):
        res = mesh_sweep(a.processes, a.sweep_device)
        shutil.rmtree(res["single"].parent, ignore_errors=True)
        print(f"sweep: MESH_SWEEP_OK shards={a.processes} runs={res['runs']} "
              f"byte_identical={res['compared']} rc={res['rcs'][0]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

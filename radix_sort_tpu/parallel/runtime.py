"""Multi-host runtime helpers.

The reference is a single-process program (no MPI/NCCL anywhere — SURVEY
§2.2); here the equivalent runtime is `jax.distributed` for process-level
bring-up plus a device mesh for the collectives. These helpers wrap both so
launch scripts stay one-liners.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize_multihost", "data_mesh", "shard_rows", "run_local_cluster",
]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the multi-host runtime (idempotent; no-op single-process).

    With no arguments, relies on the cluster environment's auto-detection
    (e.g. SLURM or Open MPI variables); arguments override for manual
    launches. A plain GPU host has no such metadata: pass all three.
    Must run before any other JAX call touches the backend.
    """
    if getattr(jax.distributed, "is_initialized", lambda: False)():
        return  # idempotent
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        # ValueError: non-cluster environment without coordinator metadata
        # ("coordinator_address should be defined") — the documented no-op
        # single-process case. RuntimeError: double init ("should only be
        # called once") or late init.
        msg = str(e)
        if "called once" in msg or "already initialized" in msg:
            return
        if "must be called before" in msg:
            raise RuntimeError(
                "initialize_multihost must run before any JAX computation "
                "initializes the backend; call it first in the launch script"
            ) from e
        if num_processes in (None, 1) and coordinator_address is None:
            return  # single-process environment without cluster metadata
        # the caller explicitly asked for a multi-process cluster: a failed
        # bring-up must NOT silently degrade to local-only JAX (collectives
        # would hang or compute on a fraction of the devices)
        raise


def run_local_cluster(
    num_processes: int = 2,
    devices_per_process: int = 2,
    module: str = "radix_sort_tpu.parallel.mp_smoke",
    extra_args: list[str] | None = None,
    timeout: float = 1800.0,
    env_overrides: dict | None = None,
):
    """Launch ``num_processes`` local Python processes that each call
    :func:`initialize_multihost` against a shared coordinator and run
    ``module``'s CLI (default: the :mod:`.mp_smoke` engine smoke) — a
    multi-host-shaped execution of the distributed engine on one machine,
    with a REAL process boundary between the mesh's device groups (the
    cross-process analogue of the reference's thread join,
    src/radix_sort/mod.rs:103-108, carried by jax.distributed/Gloo
    instead of shared memory).

    Each child runs on the CPU backend (``JAX_PLATFORMS=cpu``) with
    ``devices_per_process`` virtual devices, so no child ever opens a GPU
    on the host, and the global mesh has
    ``num_processes * devices_per_process`` devices and every collective
    crosses the process boundary. Returns the list of per-process
    ``(returncode, stdout+stderr)``; raises if any process fails or the
    cluster deadlocks past ``timeout``.
    """
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # force N virtual CPU devices per process, replacing any inherited
    # device-count flag
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    flags.append(
        f"--xla_force_host_platform_device_count={devices_per_process}"
    )
    env["XLA_FLAGS"] = " ".join(flags)
    env.update(env_overrides or {})

    procs = []
    for pid in range(num_processes):
        cmd = [
            sys.executable, "-m", module,
            "--coordinator", coord,
            "--num-processes", str(num_processes),
            "--process-id", str(pid),
        ] + list(extra_args or [])
        procs.append(subprocess.Popen(
            cmd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    results, failed = [], []
    try:
        for pid, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            results.append((p.returncode, out))
            if p.returncode != 0:
                failed.append(pid)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()  # exact PIDs we started, never by pattern
        for p in procs:
            p.communicate()
        raise RuntimeError(
            f"local cluster deadlocked past {timeout}s "
            f"({num_processes} processes x {devices_per_process} devices)"
        )
    if failed:
        detail = "\n".join(
            f"--- process {pid} (rc={results[pid][0]}) ---\n"
            + results[pid][1][-4000:]
            for pid in failed
        )
        raise RuntimeError(f"local cluster processes failed:\n{detail}")
    return results


def data_mesh(axis_name: str = "x", devices=None) -> Mesh:
    """1-D mesh over all devices — the row-sharding layout of the engine
    (rows across devices; every GPU of a host reaches every other over
    NVLink at the same rate, so the mesh follows the algorithm alone)."""
    devices = np.array(devices if devices is not None else jax.devices())
    return Mesh(devices, (axis_name,))


def shard_rows(mesh: Mesh, *arrays, axis_name: str = "x"):
    """Place arrays row-sharded over the mesh axis."""
    sharding = NamedSharding(mesh, P(axis_name))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out[0] if len(out) == 1 else out

"""Replica process management for the fleet router (port of
`aphrodite_tpu/fleet/launcher.py`, copied with its import paths
rewritten).

The router balances over HTTP URLs and does not care who owns the
processes behind them; this module is the owner used by the rollout
hook and the fleet bench: it spawns each replica as a real server
process (`python -m aphrodite_tpu_torch.endpoints.openai.api_server`),
waits for readiness via the `/health?probe=1` fast path, restarts a
replica for a rolling deploy, and SIGKILLs one for chaos proofs.

Replicas on one card share it: each sizes its KV pool as the card's
memory times `--gpu-memory-utilization` less its own peak, so N
replicas on one card each need `--gpu-memory-utilization` at most 1/N
in `extra_args`. On the CPU, pass `--device cpu` there.

Everything is asyncio-native (`asyncio.create_subprocess_exec`) so
the launcher can live on the router's event loop without blocking
it.
"""
from __future__ import annotations

import asyncio
import os
import socket
import sys
import time
from typing import Dict, List, Optional, Sequence

import aiohttp

from aphrodite_tpu_torch.common.logger import init_logger
from aphrodite_tpu_torch.fleet.replica import ROUTABLE_STATES, ReplicaHandle

logger = init_logger(__name__)


def find_free_ports(n: int) -> List[int]:
    """`n` distinct free localhost TCP ports. The sockets are held
    open until all are found so the ports are distinct, then closed —
    the usual (small, acceptable) race with other processes."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


class ReplicaProcess:
    """One replica server subprocess bound to a fixed local port (the
    port survives restarts so the replica's URL is stable)."""

    def __init__(self, name: str, port: int, argv: Sequence[str],
                 env: Optional[Dict[str, str]] = None,
                 log_path: Optional[str] = None) -> None:
        self.name = name
        self.port = port
        self.argv = list(argv)
        self.env = dict(env) if env is not None else None
        self.log_path = log_path
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.spawn_count = 0

    def _open_log_fd(self) -> int:
        if self.log_path is None:
            return os.open(os.devnull, os.O_WRONLY)
        return os.open(self.log_path,
                       os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)

    async def spawn(self) -> None:
        log_fd = self._open_log_fd()
        try:
            self.proc = await asyncio.create_subprocess_exec(
                *self.argv, env=self.env, stdout=log_fd,
                stderr=log_fd)
        finally:
            os.close(log_fd)
        self.spawn_count += 1
        logger.info("replica %s: spawned pid %d (port %d)", self.name,
                    self.proc.pid, self.port)

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.returncode is None

    async def wait_exit(self, timeout_s: float) -> bool:
        if self.proc is None:
            return True
        try:
            await asyncio.wait_for(self.proc.wait(),
                                   timeout=timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    async def terminate(self, grace_s: float = 60.0) -> None:
        """SIGTERM (the replica drains then exits clean); SIGKILL if
        it overstays the grace period."""
        if not self.running:
            return
        self.proc.terminate()
        if not await self.wait_exit(grace_s):
            logger.warning("replica %s ignored SIGTERM for %.0fs; "
                           "killing", self.name, grace_s)
            self.proc.kill()
            await self.wait_exit(10.0)

    def kill(self) -> None:
        """SIGKILL — the chaos verb: no drain, no goodbye."""
        if self.running:
            self.proc.kill()

    async def restart(self, grace_s: float = 60.0) -> None:
        await self.terminate(grace_s)
        await self.spawn()


class FleetLauncher:
    """Spawn and manage N OpenAI-server replicas of one model.

    `handles()` returns the router-facing :class:`ReplicaHandle` list;
    `restart` matches the router's ``restart_cb`` signature so a
    rollout can bounce real processes.
    """

    def __init__(self, model: str, num_replicas: int,
                 admin_key: str = "fleet-admin",
                 served_model_name: str = "fleet",
                 extra_args: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None,
                 log_dir: Optional[str] = None,
                 ports: Optional[Sequence[int]] = None) -> None:
        self.admin_key = admin_key
        self.served_model_name = served_model_name
        ports = list(ports) if ports else find_free_ports(num_replicas)
        base_env = dict(os.environ)
        if env:
            base_env.update(env)
        self.processes: List[ReplicaProcess] = []
        self._handles: List[ReplicaHandle] = []
        self._by_url: Dict[str, ReplicaProcess] = {}
        for i in range(num_replicas):
            name = f"replica-{i}"
            argv = [
                sys.executable, "-m",
                "aphrodite_tpu_torch.endpoints.openai.api_server",
                "--model", model,
                "--host", "127.0.0.1",
                "--port", str(ports[i]),
                "--served-model-name", served_model_name,
                "--admin-key", admin_key,
                *extra_args,
            ]
            log_path = (os.path.join(log_dir, f"{name}.log")
                        if log_dir else None)
            proc = ReplicaProcess(name, ports[i], argv, env=base_env,
                                  log_path=log_path)
            handle = ReplicaHandle(f"http://127.0.0.1:{ports[i]}",
                                   name=name, admin_key=admin_key)
            self.processes.append(proc)
            self._handles.append(handle)
            self._by_url[handle.url] = proc

    def handles(self) -> List[ReplicaHandle]:
        return list(self._handles)

    def process_for(self, handle: ReplicaHandle) -> ReplicaProcess:
        return self._by_url[handle.url]

    async def start_all(self, ready_timeout_s: float = 180.0) -> None:
        """Spawn every replica, then wait until each serves a
        routable /health probe (engine built, loop ready)."""
        for proc in self.processes:
            await proc.spawn()
        async with aiohttp.ClientSession() as session:
            await asyncio.gather(*(
                self._wait_ready(session, h, ready_timeout_s)
                for h in self._handles))

    async def _wait_ready(self, session: aiohttp.ClientSession,
                          handle: ReplicaHandle,
                          timeout_s: float) -> None:
        t_end = time.monotonic() + timeout_s
        proc = self.process_for(handle)
        while time.monotonic() < t_end:
            if not proc.running:
                raise RuntimeError(
                    f"{handle.name} exited during startup "
                    f"(rc={proc.proc.returncode}); see "
                    f"{proc.log_path or 'its stderr'}")
            try:
                async with session.get(
                        handle.url + "/health", params={"probe": "1"},
                        timeout=aiohttp.ClientTimeout(
                            total=2.0)) as resp:
                    body = await resp.json()
                if body.get("state") in ROUTABLE_STATES:
                    return
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    ValueError):
                pass
            await asyncio.sleep(0.2)
        raise TimeoutError(
            f"{handle.name} not ready after {timeout_s:.0f}s")

    async def restart(self, handle: ReplicaHandle,
                      grace_s: float = 60.0) -> None:
        """The router's rollout ``restart_cb``: bounce the replica's
        process (the rollout already drained it, so SIGTERM exits
        promptly) and return once the new process EXISTS — readiness
        is the rollout's own wait-for-RUNNING step."""
        await self.process_for(handle).restart(grace_s)

    def kill(self, index: int) -> None:
        self.processes[index].kill()

    async def shutdown(self) -> None:
        for proc in self.processes:
            proc.kill()
        await asyncio.gather(*(p.wait_exit(10.0)
                               for p in self.processes))

"""Multi-worker launcher: one owner process + N SO_REUSEPORT workers
(port of ucfp_tpu/server/multiworker.py).

``python -m ucfp_tpu_torch.server --bind H:P --token T --data-dir D --workers N``

runs THIS module in the parent: it opens the real stores (WAL + the
device caches on the card + keystore + accounts + the inputs cache — the
single-writer set, see server/ipc.py for the ownership protocol), serves
them on ``<data-dir>/owner.sock``, and supervises N worker subprocesses
that each bind the same HTTP port with SO_REUSEPORT. The kernel
load-balances connections across workers; each worker does the
per-request CPU work (parse, auth, decode, resize, fingerprints on the
CPU) and crosses to the owner only for index, keystore, account and
inputs-cache operations.

Only the owner holds the card. Workers are new interpreters started with
subprocess (never a fork of the owner, which has CUDA state), run
``--device cpu`` with ``CUDA_VISIBLE_DEVICES=""``: their integer image
hashes are bit-equal to the card's (the float64 products' parity
contract). The owner runs the boot warm-up on the card; workers skip it.
Workers always serve the asyncio front (UCFP_HTTP is not passed on: the
native front takes no SO_REUSEPORT).

Failure semantics:
  * worker dies -> kernel stops routing to it; the supervisor restarts
    it (capped at _MAX_RESTARTS per _RESTART_WINDOW_S, then the stack
    shuts down rather than flap forever).
  * owner dies -> workers answer 503 (store down) until the supervisor
    exits; there is no split-brain because nothing but the owner ever
    opened the WAL.
  * SIGTERM -> workers get SIGTERM first (they drain in-flight HTTP),
    then the owner closes the stores (WAL flushed) and exits 0.

Known multi-worker approximations: per-worker rate-limit buckets (the
launcher divides the configured rps/burst by N; SO_REUSEPORT spreads
connections about uniformly so the aggregate approximates the configured
limit), per-worker /metrics, and issued-key revocation visible to other
workers within UCFP_IPC_AUTH_TTL_S (default 2 s).
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import time

_MAX_RESTARTS = 5
_RESTART_WINDOW_S = 60.0


def _worker_cmd(bind: str, sock_path: str, args) -> list[str]:
    cmd = [sys.executable, "-m", "ucfp_tpu_torch.server",
           "--bind", bind, "--worker-of", sock_path, "--device", "cpu"]
    if args.token:
        cmd += ["--token", args.token]
    if args.keys_file:
        cmd += ["--keys-file", args.keys_file]
    if args.usage_log:
        cmd += ["--usage-log", args.usage_log]
    if args.data_dir:
        cmd += ["--data-dir", args.data_dir]
    return cmd


def _worker_env(n_workers: int) -> dict:
    env = dict(os.environ)
    # workers must never claim the card: the owner holds it
    env["CUDA_VISIBLE_DEVICES"] = ""
    # the owner warms the card; a worker has nothing there to warm
    env["UCFP_WARMUP"] = "0"
    # every worker binds the shared port with SO_REUSEPORT, which only
    # the asyncio front does: a native front in each would fail with
    # EADDRINUSE
    env.pop("UCFP_HTTP", None)
    # split the in-memory token buckets across workers so the
    # aggregate approximates the configured limit (webhook limiters
    # are centralized already and pass through untouched)
    if not env.get("UCFP_RATELIMIT_URL"):
        rate = float(env.get("UCFP_RATELIMIT_RPS", "100"))
        burst = float(env.get("UCFP_RATELIMIT_BURST", "200"))
        if rate > 0:
            env["UCFP_RATELIMIT_RPS"] = str(rate / n_workers)
            env["UCFP_RATELIMIT_BURST"] = str(max(1.0, burst / n_workers))
    return env


async def _run_owner(bind: str, state, sock_path: str, n_workers: int,
                     args) -> None:
    from .app import kernel_launches
    from .ipc import OwnerServer
    from .logging import logger

    owner = OwnerServer(state.index, keystore=state.keystore,
                        accounts=state.accounts, path=sock_path,
                        inputs=state.inputs)
    await owner.start()
    logger().info("owner", sock=sock_path, workers=n_workers,
                  device=str(state.index.device))
    if os.environ.get("UCFP_WARMUP", "1") != "0":
        from .warmup import start_background_warmup

        start_background_warmup(state.index.device)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass

    env = _worker_env(n_workers)
    cmd = _worker_cmd(bind, sock_path, args)
    procs: list[subprocess.Popen] = [
        subprocess.Popen(cmd, env=env) for _ in range(n_workers)
    ]
    restarts: list[float] = []

    async def supervise() -> None:
        while not stop.is_set():
            await asyncio.sleep(0.5)
            for i, p in enumerate(procs):
                rc = p.poll()
                if rc is None:
                    continue
                now = time.monotonic()
                restarts.append(now)
                while restarts and now - restarts[0] > _RESTART_WINDOW_S:
                    restarts.pop(0)
                if len(restarts) > _MAX_RESTARTS:
                    logger().error("workers_flapping", restarts=len(restarts))
                    stop.set()
                    return
                logger().warn("worker_died", pid=p.pid, returncode=rc)
                procs[i] = subprocess.Popen(cmd, env=env)

    sup = asyncio.create_task(supervise())
    await stop.wait()
    sup.cancel()
    try:
        await sup
    except asyncio.CancelledError:
        pass

    logger().info("draining_workers", n=len(procs))
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + float(os.environ.get("UCFP_DRAIN_SECS",
                                                       "10")) + 5.0
    for p in procs:
        while p.poll() is None and time.monotonic() < deadline:
            await asyncio.sleep(0.1)
        if p.poll() is None:
            p.kill()
    await owner.close()
    try:
        state.index.close()
    except Exception as e:  # pragma: no cover
        logger().warn("index_close_failed", error=str(e))
    logger().info("stopped", workers=n_workers, kernel_launches=kernel_launches())
    logger().close()


def run_multiworker(bind: str, n_workers: int, args) -> None:
    """Owner entry point (called from server.__main__)."""
    from .app import state_from_env

    state = state_from_env(
        data_dir=args.data_dir,
        token=args.token,
        keys_file=args.keys_file,
        usage_log=args.usage_log,
        device=args.device,
    )
    data_dir = args.data_dir or os.environ.get("UCFP_DATA_DIR",
                                               "./ucfp-data")
    sock_path = os.path.join(data_dir, "owner.sock")
    try:
        asyncio.run(_run_owner(bind, state, sock_path, n_workers, args))
    except KeyboardInterrupt:
        pass


def run_worker(bind: str, sock_path: str, args) -> None:
    """Worker entry point: HTTP front over Remote* proxies, hashing on
    args.device (the CPU: _worker_cmd passes --device cpu)."""
    from .app import run, state_from_env
    from .ipc import RemoteAccounts, RemoteBackend, RemoteInputs, RemoteKeyStore

    state = state_from_env(
        data_dir=args.data_dir,
        token=args.token,
        keys_file=args.keys_file,
        usage_log=args.usage_log,
        index=RemoteBackend(sock_path, device=args.device),
        keystore=RemoteKeyStore(sock_path),
        accounts=RemoteAccounts(sock_path),
        inputs=RemoteInputs(sock_path),
    )
    try:
        asyncio.run(run(bind, state, native_http=False, reuse_port=True))
    except KeyboardInterrupt:
        pass

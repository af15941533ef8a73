"""CLI launcher: python -m ucfp_tpu_torch.server --bind HOST:PORT --token T --data-dir D
[--usage-log PATH] [--device cuda] [--native-http] [--workers N]."""

import argparse
import asyncio
import os

from .app import run, state_from_env


def main() -> None:
    p = argparse.ArgumentParser(prog="ucfp-tpu-torch-server")
    p.add_argument("--bind", default=None, help="host:port (env UCFP_BIND)")
    p.add_argument("--token", default=None, help="service bearer (env UCFP_TOKEN)")
    p.add_argument("--keys-file", default=None, help="multi-tenant keys file")
    p.add_argument("--data-dir", default=None, help="index directory")
    p.add_argument("--usage-log", default=None,
                   help="NDJSON usage log path (env UCFP_USAGE_LOG_PATH)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the index and the hashes (default cuda; "
                        "with two or more cards the index shards over them unless "
                        "UCFP_SHARD=off; cpu never shards)")
    p.add_argument("--native-http", action="store_true",
                   help="serve through the C++ epoll front (env UCFP_HTTP=native)")
    p.add_argument("--workers", type=int, default=None,
                   help="N SO_REUSEPORT HTTP workers on the CPU over one owner "
                        "process that holds the store and the card (env "
                        "UCFP_WORKERS; see server/ipc.py)")
    p.add_argument("--worker-of", default=None, metavar="SOCK",
                   help=argparse.SUPPRESS)  # internal: worker mode
    args = p.parse_args()
    bind = args.bind or os.environ.get("UCFP_BIND", "127.0.0.1:8080")
    if args.worker_of:
        from .multiworker import run_worker

        run_worker(bind, args.worker_of, args)
        return
    # on-demand kernel tracing: a loopback endpoint that records
    # torch.profiler for a stated window (server/profiler.py); under
    # --workers it runs in the owner, the one process on the card
    prof_port = os.environ.get("UCFP_PROFILER_PORT")
    if prof_port:
        from .profiler import start_profiler_server

        start_profiler_server(int(prof_port))
    workers = args.workers if args.workers is not None else int(
        os.environ.get("UCFP_WORKERS", "0") or 0)
    if workers > 0:
        from .multiworker import run_multiworker

        run_multiworker(bind, workers, args)
        return
    state = state_from_env(data_dir=args.data_dir, token=args.token,
                           keys_file=args.keys_file, usage_log=args.usage_log,
                           device=args.device)
    try:
        asyncio.run(run(bind, state, native_http=args.native_http or None))
    except KeyboardInterrupt:
        pass  # graceful ctrl-c shutdown


if __name__ == "__main__":
    main()

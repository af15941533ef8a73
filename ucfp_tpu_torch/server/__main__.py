"""CLI launcher: python -m ucfp_tpu_torch.server --bind HOST:PORT --token T --data-dir D
[--usage-log PATH] [--device cuda]."""

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
                   help="not served by this build yet: refuses to start")
    p.add_argument("--workers", type=int, default=None,
                   help="not served by this build yet: a value above 0 "
                        "refuses to start")
    args = p.parse_args()
    bind = args.bind or os.environ.get("UCFP_BIND", "127.0.0.1:8080")
    state = state_from_env(data_dir=args.data_dir, token=args.token,
                           keys_file=args.keys_file, usage_log=args.usage_log,
                           device=args.device, workers=args.workers,
                           native_http=args.native_http or None)
    try:
        asyncio.run(run(bind, state))
    except KeyboardInterrupt:
        pass  # graceful ctrl-c shutdown


if __name__ == "__main__":
    main()

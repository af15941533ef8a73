"""Bulk-ingest CLI: drain a spool into the index without the HTTP tier.

    python -m ucfp_tpu_torch.ingest --data-dir /var/lib/ucfp --spool ./spool
    python -m ucfp_tpu_torch.ingest --data-dir /var/lib/ucfp --ndjson rows.ndjson
    python -m ucfp_tpu_torch.ingest ... --device cpu   (no GPU)

The spool form fingerprints content files ({tenant}_{record}.{ext};
txt/md/html, png/jpg/webp/bmp/gif, wav/f32) through the device kernels
in batches; the ndjson form loads pre-computed Record rows (the
PUT /v1/records shape) with a durable resume offset. Both run on the
CUDA card unless --device names another torch device.

Copied from ucfp_tpu/ingest/__main__.py; its imports differ and it takes
--device.
"""

from __future__ import annotations

import argparse
import asyncio
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ucfp_tpu_torch.ingest")
    ap.add_argument("--data-dir", required=True, help="index data directory")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--spool", help="content-file spool directory")
    src.add_argument("--ndjson", help="NDJSON Record spool file")
    ap.add_argument("--tenant", type=int, default=0,
                    help="default tenant for unprefixed spool files")
    ap.add_argument("--sample-rate", type=int, default=8000,
                    help="sample rate for raw .f32 spool files")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the index and the fingerprints "
                         "(default cuda; cpu runs without a GPU)")
    args = ap.parse_args(argv)

    from ..index.embedded import EmbeddedBackend
    from .source import run_ingest_loop

    if args.spool:
        from .filesource import SpoolDirectoryIngestSource

        source = SpoolDirectoryIngestSource(
            args.spool, default_tenant=args.tenant,
            sample_rate=args.sample_rate, device=args.device,
        )
    else:
        from .filesource import NdjsonIngestSource

        source = NdjsonIngestSource(args.ndjson)

    index = EmbeddedBackend(args.data_dir, device=args.device)
    try:
        total = asyncio.run(
            run_ingest_loop(source, index, batch_size=args.batch_size)
        )
        asyncio.run(index.flush())
    finally:
        index.close()
    skipped = getattr(source, "skipped", 0) or len(
        getattr(source, "errors", [])
    )
    print(f"ingested {total} record(s), {skipped} skipped/failed")
    for name, err in getattr(source, "errors", [])[:20]:
        print(f"  failed: {name}: {err}", file=sys.stderr)
    return 0 if total or not skipped else 1


if __name__ == "__main__":
    raise SystemExit(main())

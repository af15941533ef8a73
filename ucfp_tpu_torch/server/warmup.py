"""Boot-time warm-up: the first use of each device path, off the request
path (port of ucfp_tpu/server/warmup.py).

What the first request would otherwise pay on the card is the build of
the kernel library when `_build/` is missing or stale (nvcc, tens of
seconds), its first load and the first launch of each kernel, the CUDA
context and the cuBLAS handle. This runs small synthetic payloads
through each modality's fingerprint path, the reference's families, and
launches each fused scan family once at the fused floor of 32,768 rows
(ROWS_PER_TILE x LANES: below it the exact paths serve and no kernel
runs) at the serving dims, on a background thread right after boot; the
buffers are freed afterwards. Dims are the built-in encoders' (audio 128,
text 384, image 512) plus 64 and the BASELINE 768; UCFP_WARMUP_DIMS
overrides. The launcher runs it by default; UCFP_WARMUP=0 turns it off
(tests construct servers directly and never run it). A failure is
logged as a warning and never takes the server down.
"""

from __future__ import annotations

import os
import threading
import time

from .logging import logger


def _ann(torch, device, dims: list[int], quant: str, k: int) -> None:
    import numpy as np

    from ..ops import fused_scan
    from ..ops import knn as knn_ops

    rows = fused_scan.ROWS_PER_TILE * fused_scan.LANES
    valid = torch.arange(rows, device=device) < 16
    for d in dims:
        # zeros with 16 unit rows: 16 valid hits, the rest masked
        m = torch.zeros((rows, d), dtype=torch.float32, device=device)
        m[:16, 0] = 1.0
        if quant in ("int8", "int4", "int2", "sketch"):
            # the int8 catalog as the backend lays it out: [rows, D8]
            q8, rn = knn_ops.quantize_rows_int8(m.cpu().numpy())
            q8m = torch.zeros((rows, knn_ops.padded_dim(d)), dtype=torch.int8, device=device)
            q8m[:, :d] = torch.from_numpy(q8).to(device)
            rn = torch.from_numpy(rn).to(device)
            qq = knn_ops._quantize_query_rows(m[:2])
            dots = knn_ops.int8_dots(qq, q8m)
            inv_q = torch.ones(2, dtype=torch.float32, device=device)
            # #4 (one query) and #5 (a batch) over the int8 product
            fused_scan.dots_norm_topk_fused(dots[0], rn, 16, np.float32(1.0), k)
            fused_scan.dots_norm_topk_fused_batched(dots, rn, 16, inv_q, k)
            # filtered queries: the masked scores through #3 / #1
            knn_ops.cosine_topk_int8(m[:1], q8m, rn, valid, k)
            if quant == "int4" and d % 2 == 0:
                packed_t, inv_n = knn_ops.pack_int4_cols(q8m[:, :d])
                pool = knn_ops.int4_pool(rows, k)
                # fused (unfiltered, prefix validity) and masked (filtered)
                knn_ops.cosine_int4_topk(m[0], q8m, rn, packed_t, inv_n, valid, k, pool,
                                         n_valid=16)
                knn_ops.cosine_int4_topk(m[0], q8m, rn, packed_t, inv_n, valid, k, pool)
                knn_ops.cosine_int4_topk_batched(m[:2], q8m, rn, packed_t, inv_n, 16, k,
                                                 knn_ops.int4_batch_pool(rows, k))
            if quant == "int2" and d % 4 == 0:
                packed_t, inv_n = knn_ops.pack_int2_cols(q8m[:, :d])
                pool = knn_ops.int2_pool(rows, k)
                knn_ops.cosine_int2_topk(m[0], q8m, rn, packed_t, inv_n, valid, k, pool,
                                         n_valid=16)
                knn_ops.cosine_int2_topk(m[0], q8m, rn, packed_t, inv_n, valid, k, pool)
                knn_ops.cosine_int2_topk_batched(m[:2], q8m, rn, packed_t, inv_n, 16, k,
                                                 knn_ops.int2_batch_pool(rows, k))
            if quant == "sketch":
                planes = torch.as_tensor(knn_ops.sketch_planes(d), device=device)
                sketch = knn_ops.tile_sketch(knn_ops.build_sketch_chunked(q8m[:, :d], planes))
                knn_ops.cosine_sketch_topk(m[0], planes, q8m, rn, sketch, valid, k,
                                           knn_ops.sketch_pool(rows, k))
        else:
            # #1 (the f32 scores' cells) and the selection
            knn_ops.cosine_topk_fused(m[:1], m, valid, k)
            fused_scan.scores_topk_fused(
                knn_ops._cosine_scores(m[:1], m, valid)[0], k)
        del m
    h = torch.zeros((rows, 2), dtype=torch.int32, device=device)
    # #2 (the batched Hamming scan) for the fingerprint queries
    fused_scan.hamming_topk_fused_batched(h[:1], h, valid, k)


def _work(device) -> None:
    import numpy as np
    import torch

    t0 = time.monotonic()
    done = []
    try:
        # text: the host MinHash path
        from ..modality import text as tmod

        tmod.fingerprint_minhash("warmup quick brown fox sample text", 0, 0)
        done.append("text")

        # image: the multihash and single-hash kernels at the
        # playground's canonical small shape
        from ..ops import imagehash

        gray = np.zeros((1, 64, 64), np.uint8)
        imagehash.multihash_kernel_gray(gray, 64, 64, device=device)
        imagehash.single_hash_kernel_gray(gray, 64, 64, "phash", device=device)
        done.append("image")
        # the coalesced bulk-ingest launch (UCFP_INGEST_COALESCE_MS > 0)
        if float(os.environ.get("UCFP_INGEST_COALESCE_MS", "0") or 0) > 0:
            rows = int(os.environ.get("UCFP_INGEST_COALESCE_ROWS", "8192"))
            imagehash.single_hash_kernel_gray(np.zeros((rows, 32, 32), np.uint8), 32, 32,
                                              "phash", device=device)
            done.append("image-coalesced")

        # audio: the STFT + peak + pairing pipeline at two durations
        from ..modality import audio as amod

        for secs in (1, 4):
            t = np.arange(8000 * secs, dtype=np.float32) / 8000.0
            x = (0.25 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
            amod.fingerprint_wang(x, 8000, 0, 0, device=device)
        done.append("audio")

        # ANN at the serving dims and the request default k = 10
        dims = [int(d) for d in os.environ.get(
            "UCFP_WARMUP_DIMS", "64,128,384,512,768").split(",") if d.strip()]
        quant = os.environ.get("UCFP_KNN_QUANT", "none").lower()
        _ann(torch, device, dims, quant, 10)
        done.append("ann" if quant == "none" else f"ann-{quant}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()  # the warm-up's buffers go back
    except Exception as e:  # warm-up must never take the server down
        logger().warn("warmup error", err=f"{type(e).__name__}: {e}",
                      completed=",".join(done))
        return
    logger().info("warmup complete", secs=round(time.monotonic() - t0, 3),
                  kernels=",".join(done))


def start_background_warmup(device) -> threading.Thread:
    """Fire-and-forget warm-up thread on `device` (daemon: never blocks
    shutdown)."""
    import torch

    t = threading.Thread(target=_work, args=(torch.device(device),), name="ucfp-warmup",
                         daemon=True)
    t.start()
    return t

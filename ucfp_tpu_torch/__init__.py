"""ucfp_tpu_torch — the PyTorch + CUDA port of ucfp_tpu, for NVIDIA Hopper.

This slice serves image fingerprints and vectors: image ingest (pHash /
dHash / aHash / the 536-byte multi bundle) -> WAL-durable store -> the
Hamming, weighted multi-hash and f32 cosine queries, over the same HTTP
API and the same on-disk log as ucfp_tpu. The package imports nothing
of the reference package: the host modules it shares are copies.

Layer map (the reference's names, so each module's counterpart is easy
to find):
  core/      record / query / hit contract + error taxonomy (copied)
  ops/       device code: imagehash, knn, fused_scan (CUDA kernels)
  csrc/      the CUDA C++ kernel sources (sm_90a)
  modality/  image decode + hashing entry points
  index/     WAL (copied) + EmbeddedBackend with device caches
  matcher/   query orchestration + RRF (copied)
  ingest/    deadline batcher (copied)
  server/    HTTP API, auth, logging
  device.py  device resolution (CUDA unless the caller names the CPU)
  _build.py  build-at-first-use for csrc/ and native/
"""

__version__ = "0.1.0"

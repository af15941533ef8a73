"""Remote semantic embedding providers: OpenAI / Voyage / Cohere.

A copy of ucfp_tpu/modality/providers.py; only its imports differ.

Wire-correct request/response codecs for the three hosted embedding APIs
the reference supports (src/modality/text.rs:500-606 via txtfp's
provider SDKs; key pass-through at src/server/handlers.rs:369-375).
Each provider here speaks its public REST shape:

  openai  POST {base}/v1/embeddings     {"model", "input": [text]}
          -> {"data": [{"embedding": [...]}], "model": "..."}
  voyage  POST {base}/v1/embeddings     {"model", "input": [text]}
          -> {"data": [{"embedding": [...]}], "model": "..."}
  cohere  POST {base}/v1/embed          {"model", "texts": [text],
                                         "input_type": "search_document"}
          -> {"embeddings": [[...]], ...}

Auth is a caller-supplied bearer key (the server forwards
`X-Provider-Key`; keys are NEVER logged or stored). Base URLs are
env-overridable (UCFP_PROVIDER_<NAME>_URL) so deployments can point at
proxies — and the test suite at local stub servers; this build has zero
egress, so the defaults are unreachable here but the codecs are the
production contract.

Failures map to ProviderError (502): connection errors, non-2xx, and
malformed payloads. Missing key/model are client errors (400) raised by
the caller before any request is made.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np

from ..core import ProviderError

DEFAULT_BASE = {
    "openai": "https://api.openai.com",
    "voyage": "https://api.voyageai.com",
    "cohere": "https://api.cohere.ai",
}

DEFAULT_MODEL = {
    "openai": "text-embedding-3-small",
    "voyage": "voyage-3-lite",
    "cohere": "embed-english-v3.0",
}

_TIMEOUT = float(os.environ.get("UCFP_PROVIDER_TIMEOUT_S", "10"))


def base_url(provider: str) -> str:
    return os.environ.get(
        f"UCFP_PROVIDER_{provider.upper()}_URL", DEFAULT_BASE[provider]
    ).rstrip("/")


def _request(provider: str, path: str, payload: dict, api_key: str) -> dict:
    url = base_url(provider) + path
    body = json.dumps(payload).encode()
    req = urllib.request.Request(
        url,
        data=body,
        method="POST",
        headers={
            "content-type": "application/json",
            "authorization": f"Bearer {api_key}",
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=_TIMEOUT) as resp:
            raw = resp.read()
    except urllib.error.HTTPError as e:
        # read the provider's error body for the message, never echo the key
        detail = ""
        try:
            detail = e.read(512).decode("utf-8", "replace")
        except Exception:
            pass
        raise ProviderError(
            f"{provider} returned {e.code}: {detail[:200]}"
        )
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise ProviderError(f"{provider} unreachable: {e}")
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ProviderError(f"{provider} sent malformed JSON: {e}")


def _vector(obj, provider: str) -> np.ndarray:
    try:
        v = np.asarray(obj, np.float32)
    except (TypeError, ValueError):
        raise ProviderError(f"{provider} embedding is not a float vector")
    if v.ndim != 1 or v.size == 0 or not np.all(np.isfinite(v)):
        raise ProviderError(f"{provider} embedding has a bad shape")
    return v


def embed(provider: str, text: str, model: str, api_key: str) -> tuple[np.ndarray, str]:
    """One embedding round-trip. Returns (vector f32, model_id as the
    provider reported it, falling back to the requested model)."""
    if provider in ("openai", "voyage"):
        out = _request(
            provider, "/v1/embeddings",
            {"model": model, "input": [text]}, api_key,
        )
        try:
            vec = out["data"][0]["embedding"]
        except (KeyError, IndexError, TypeError):
            raise ProviderError(f"{provider} response missing data[0].embedding")
        return _vector(vec, provider), str(out.get("model") or model)
    if provider == "cohere":
        out = _request(
            provider, "/v1/embed",
            {"model": model, "texts": [text],
             "input_type": "search_document"}, api_key,
        )
        embs = out.get("embeddings")
        # v1 returns {"embeddings": [[...]]}; the v2-style shape nests
        # under {"embeddings": {"float": [[...]]}} — accept both
        if isinstance(embs, dict):
            embs = embs.get("float")
        try:
            vec = embs[0]
        except (IndexError, TypeError):
            raise ProviderError("cohere response missing embeddings[0]")
        return _vector(vec, "cohere"), model
    raise ProviderError(f"unknown provider {provider!r}")

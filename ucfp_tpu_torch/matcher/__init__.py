"""Hybrid retrieval orchestration (layer 4).

Copied from ucfp_tpu/matcher/__init__.py; only its imports differ.
"""

from .rrf import rrf, rrf_with_sources
from .matcher import Matcher

__all__ = ["rrf", "rrf_with_sources", "Matcher"]

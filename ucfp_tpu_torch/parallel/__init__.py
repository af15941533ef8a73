"""Sharded serving: device meshes (mesh) and the row-sharded top-k with
its cross-shard merge (sharded_knn)."""

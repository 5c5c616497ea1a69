"""Device-mesh utilities and the edge-sharded bundle adjustment."""

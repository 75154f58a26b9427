"""Serving: continuous batching over 2-D DISC shape buckets."""

"""Model-zoo families ported so far (dense decoder-only transformer)."""

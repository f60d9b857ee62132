"""Registration: only what serving needs (phase cross-correlation)."""

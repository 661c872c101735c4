"""Atomic, restart-safe checkpoints (`io`); the elastic remesh of the
reference (`ckpt/elastic.py`) is multi-device and waits for ROADMAP A9."""

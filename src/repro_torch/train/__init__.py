"""Training: AdamW, the two one-card step variants and the KF-scheduled
fault-tolerant loop."""

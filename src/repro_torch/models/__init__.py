"""repro_torch.models — the model stack of the port (dense decoder LMs and
Mamba1 in this slice; see `lm.layer_pattern` for the kinds still to come)."""

"""repro_torch.dist — the fleet layer of the paper's technique.

The paper predicts per-link bandwidth demand with a Kalman filter and
reallocates NoC resources between pre-defined configurations; this package
applies it one layer up, to a training/serving fleet:

  kf_scheduler  KFScheduler (variant dispatch on the host) + FleetKF (one
                banked filter per pod x traffic-class, on the CUDA kf_bank
                kernel)
  telemetry     step timers + static cost models -> the KF's three
                normalized observations

The sharding, compression and pipeline modules of the JAX package belong to
the training slice (ROADMAP queue A).
"""

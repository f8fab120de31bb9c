"""Training meshes, fleet slot lists and the training launcher
(:mod:`repro_torch.launch.mesh`, :mod:`repro_torch.launch.train`)."""

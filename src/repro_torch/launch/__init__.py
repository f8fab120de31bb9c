"""Device layout for fleet serving (:mod:`repro_torch.launch.mesh`)."""

"""Launch helpers of the port (counterpart of :mod:`repro.launch`): the
serving mesh (:mod:`repro_torch.launch.mesh`)."""

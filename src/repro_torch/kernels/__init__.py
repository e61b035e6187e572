"""Hand-written Hopper kernels of the port, each beside its plain torch
version.  Sources live under ``<kernel>/csrc/`` and are compiled with nvcc at
first use by :mod:`repro_torch.kernels.build`."""

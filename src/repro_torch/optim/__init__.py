"""See the package docstring of :mod:`repro_torch`."""

"""The port's tensor functions and kernels (see the package docstring)."""

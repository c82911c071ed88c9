"""Hand-written GPU kernels, each beside the plain version it replaces."""

"""Math, intersection, kernels and their plain versions, tonemap."""

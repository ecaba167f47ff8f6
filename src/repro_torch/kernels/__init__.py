"""Hand-written Hopper kernels, their wrappers and the backend registry."""

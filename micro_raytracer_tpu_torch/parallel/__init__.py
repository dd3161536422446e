"""Meshes of devices, several processes, and training steps and rendering
over them (the counterpart of the JAX package's ``parallel``)."""

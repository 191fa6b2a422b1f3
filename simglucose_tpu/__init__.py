"""simglucose_tpu: a UVA/Padova T1D glucose simulation framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of simglucose (the
FDA-accepted UVA/Padova 2008 simulator packaged as an RL environment):
pure functions over explicit pytree state, vmapped over patient batches,
time-stepped with lax.scan, sharded over device meshes, with a Pallas
rollout kernel for the GPU.
"""
__version__ = "0.1.0"

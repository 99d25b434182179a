"""PyTorch/CUDA port of the tpu_breath serving path.

wav -> features (extract_features) -> CNN8 -> weighted sigmoid ensemble,
with the three Pallas kernels on that path (tuning tail, gammatone
epilogue, find_peaks suppression) as hand-written CUDA kernels under
csrc/. The JAX package (tpu_breath) is the reference it is tested
against; this package imports torch and never jax.
"""

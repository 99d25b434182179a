"""The plain reference of the benchmark's correctness check: the NumPy
feature oracle (features_np, dsp_np), the models in plain float32 PyTorch
(cnn8, vgg) and their training step (train). It imports nothing of the
port, of jax or of the JAX package, and takes nothing the port made."""

"""The benchmark of the PyTorch/CUDA port (``repro_torch``) of the
BiSupervised cascade: ``run.py`` runs one cell of ``BENCHMARK.json``
once. It drives the port only; it imports neither JAX nor the JAX
package."""

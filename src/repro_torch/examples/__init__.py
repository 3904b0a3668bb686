"""Runnable examples of the port, the counterparts of ``examples/*.py``.

Each module tells its JAX counterpart's story at the same sizes and has a
``main(argv=None)`` that runs it; importing a module runs nothing. Every
example takes ``--device`` (default ``cuda``; a missing GPU is an error,
never a quiet fallback) and ``--seed``, and draws from explicit
``torch.Generator``s and numpy generators::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.serve_cascade --device cpu
"""

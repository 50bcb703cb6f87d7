"""PyTorch/CUDA port of the PerFedS² simulator (``src/repro`` is the JAX
reference).  Imports ``torch`` and ``numpy`` only — never ``jax`` or
``repro``.  Entry points run on the card (``device="cuda"``) unless the
caller asks for the CPU."""

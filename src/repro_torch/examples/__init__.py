"""The port's counterparts of the JAX package's ``examples/``.

Each module has the reference example's config, printed lines and ``a.b=c``
overrides (where the reference has them), plus ``--device`` (the card by
default; ``--device cpu`` runs on the CPU), and a ``main(argv=None)`` that
returns its results:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.compare_algorithms
    PYTHONPATH=src python -m repro_torch.examples.wireless_scheduling
    PYTHONPATH=src python -m repro_torch.examples.mobile_edge [a.b=c ...]
    PYTHONPATH=src python -m repro_torch.examples.hetero_cells [a.b=c ...]
    PYTHONPATH=src python -m repro_torch.examples.serve_personalized

The simulation examples take ``max_rounds=`` (a keyword, not a flag),
which caps every run's rounds.  The end-to-end LM training example is
``repro_torch.launch.train_e2e``.
"""
